"""Shading-record resolution shared by both trace backends.

`ShadeRec` carries the winning primitive's flattened material/texture
inputs, built with per-prim 1-D gathers (`gather_shade`) from the winner
either trace backend found.  Albedo resolution (`resolve_albedo`) then
applies the procedural texture kinds on top of the constant color — the
lockstep equivalent of the reference's texture direct-callable dispatch
(texture/*.cu via closehit.cu:64-67).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp
from jax import lax

from rtw.models import scene as S
from rtw.ops import vec as V
from rtw.ops.vec import Vec3
from rtw.ops.textures import (_image_bilinear, _image_bilinear_565,
                                  _image_nearest_565, _image_stoch_565,
                                  turbulence)


class ShadeRec(NamedTuple):
    """Per-ray shading record of the winning primitive — the flattened
    MaterialParams+textureParam fetch (sysparameter.h:5-14) the reference
    does through the SBT/instance-id indirection."""

    mat_type: Any    # [N] int32
    fuzz: Any        # [N] f32
    eta: Any         # [N] f32
    tex_type: Any    # [N] int32
    scale: Any       # [N] f32
    image_id: Any    # [N] int32
    rgb: Vec3        # [N] planes: constant/albedo texture color
    odd: Vec3        # [N] planes: checker odd color
    even: Vec3       # [N] planes: checker even color


def gather_shade(scene: S.Scene, prim_idx, hit_mask) -> ShadeRec:
    """ShadeRec via per-prim column gathers (pure-JAX / differentiable path).

    Texture colors are gathered through Textures.color so gradients and
    apply_params updates flow (prim -> static tex row -> traced color)."""
    pr = scene.prims
    sp = jnp.maximum(prim_idx, 0)
    col = scene.textures.color

    def color_via(idx_col):
        rows = idx_col[sp]
        return Vec3(col[:, 0][rows], col[:, 1][rows], col[:, 2][rows])

    return ShadeRec(
        mat_type=jnp.where(hit_mask, pr.mat_type_p[sp], 0),
        fuzz=pr.fuzz_p[sp],
        eta=pr.eta_p[sp],
        tex_type=pr.tex_type_p[sp],
        scale=pr.scale_p[sp],
        image_id=pr.image_id_p[sp],
        rgb=color_via(pr.tex_idx),
        odd=color_via(pr.odd_idx),
        even=color_via(pr.even_idx),
    )


def _noise_eval(scene: S.Scene, scale, p: Vec3):
    """Marble value for every lane (hash-gradient Perlin — elementwise)."""
    m = 0.5 * (1.0 + jnp.sin(scale * p.z
                             + 5.0 * turbulence(scene.textures, p * scale)))
    return Vec3(m, m, m)


def _image_eval(scene: S.Scene, image_id, u, v, tex_filter, tex_u=None):
    """Atlas fetch for every lane (1/2/4 per-lane gathers by
    cfg.tex_filter)."""
    if tex_filter == "stoch565":
        return _image_stoch_565(scene.textures, image_id, u, v, tex_u)
    fetch = {"rgb565": _image_bilinear_565,
             "nearest565": _image_nearest_565}.get(tex_filter,
                                                   _image_bilinear)
    return fetch(scene.textures, image_id, u, v)


# Granule (lanes) of the tile-ladder atlas gate and the ladder's prefix
# fractions of T = lanes/granule.  See _image_eval_tiled.
_ATLAS_GRANULE = 1024
_ATLAS_LADDER = (8, 4, 2)


def _image_eval_tiled(scene: S.Scene, image_id, u, v, tex_filter, need,
                      tex_u=None):
    """Tile-granular atlas fetch: per-lane gathers only for 1024-lane
    granules that contain an image-texture winner.

    The per-lane atlas gather fires nearly every wavefront iteration on
    scenes 2/4 even though most granules hold no image lanes (the earth
    sphere is one small object; render.tile_permutation + pinned pixels
    keep winners spatially coherent).  Lane-level compaction costs more
    than it saves (see resolve_albedo's docstring); GRANULE-level
    compaction keeps every
    move a contiguous [1, 1024] row:

    1. reduce `need` to per-granule flags [T], partition granule ids
       needing-first (cumsum, like integrator._alive_first_perm);
    2. pick the smallest static prefix T/8 | T/4 | T/2 | T that covers
       the needing count (a lax.cond ladder — XLA needs static shapes,
       so capacity is quantized instead of exact);
    3. row-gather (u, v, image_id) for that prefix, run the per-lane
       fetch at the reduced width, row-scatter results back.

    Returns a full-width Vec3; lanes outside needing granules hold zeros
    (callers mask by `need` anyway).  Exact for needing lanes — granule
    selection only routes, never approximates."""
    n = u.shape[0]
    g = _ATLAS_GRANULE
    t = n // g
    if n % g != 0 or t < max(_ATLAS_LADDER):
        return _image_eval(scene, image_id, u, v, tex_filter, tex_u)

    u2 = u.reshape(t, g)
    v2 = v.reshape(t, g)
    xi2 = None if tex_u is None else tex_u.reshape(t, g)
    id2 = image_id.reshape(t, g)
    tn = jnp.any(need.reshape(t, g), axis=1)
    a = tn.astype(jnp.int32)
    count = jnp.sum(a)
    pos_need = jnp.cumsum(a) - 1
    pos_rest = count + jnp.cumsum(1 - a) - 1
    dest = jnp.where(tn, pos_need, pos_rest)
    perm = jnp.zeros((t,), jnp.int32).at[dest].set(
        jnp.arange(t, dtype=jnp.int32))

    zero2 = jnp.zeros((t, g), jnp.float32)

    def eval_prefix(cap):
        def run(_):
            rows = perm[:cap]
            col = _image_eval(scene, id2[rows].reshape(-1),
                              u2[rows].reshape(-1), v2[rows].reshape(-1),
                              tex_filter,
                              None if xi2 is None
                              else xi2[rows].reshape(-1))

            def put(c):
                return zero2.at[rows].set(c.reshape(cap, g))

            return put(col.x), put(col.y), put(col.z)

        return run

    # build innermost-first so the OUTERMOST cond checks the smallest cap
    chain = eval_prefix(t)
    for frac in sorted(_ATLAS_LADDER):          # 2, 4, 8 -> outermost = t//8
        cap = t // frac
        chain = (lambda cap=cap, nxt=chain: lambda _: lax.cond(
            count <= cap, eval_prefix(cap), nxt, None))()
    x2, y2, z2 = chain(None)
    return Vec3(x2.reshape(n), y2.reshape(n), z2.reshape(n))


def resolve_albedo(scene: S.Scene, shade: ShadeRec, p: Vec3, u, v,
                   tex_filter: str = "rgb565",
                   tex_tile_gate: bool = True, tex_u=None) -> Vec3:
    """Final albedo from the shading record + procedural texture kinds.

    Static `scene.tex_present` flags keep unreachable texture code out of
    the compiled program.  Checker children are constant colors (builder
    enforces one nesting level; book-correct sines product, QUIRKS #10).

    Noise and image textures run full-width under a lax.cond that skips
    bounces where no lane needs them.  A fixed-capacity side-queue
    (jnp.nonzero(size=n/8) + gather/eval/scatter) was a net loss on the
    previous accelerator — ~15 small gathers/scatters at n/8 lanes plus
    the nonzero cumsum and two cond boundaries cost more than the
    full-width eval they replace; not yet re-measured on the GPU."""
    present = scene.tex_present
    albedo = shade.rgb

    if present[S.TEX_CHECKER]:
        sines = (jnp.sin(10.0 * p.x) * jnp.sin(10.0 * p.y)
                 * jnp.sin(10.0 * p.z))
        checker = V.where(sines < 0.0, shade.odd, shade.even)
        albedo = V.where(shade.tex_type == S.TEX_CHECKER, checker, albedo)

    # Noise and image textures get SEPARATE lax.cond gates: a bounce whose
    # winners include marble lanes but no image lanes (common on TNW — the
    # earth sphere is one small object) pays the arithmetic-only Perlin but
    # skips the two per-lane atlas gathers entirely, and vice versa.
    if present[S.TEX_NOISE]:
        need_n = shade.tex_type == S.TEX_NOISE

        def _noise(a):
            return V.where(need_n, _noise_eval(scene, shade.scale, p), a)

        albedo = lax.cond(jnp.any(need_n), _noise, lambda a: a, albedo)

    if present[S.TEX_IMAGE]:
        need_i = shade.tex_type == S.TEX_IMAGE

        def _image(a):
            if tex_tile_gate:
                img = _image_eval_tiled(scene, shade.image_id, u, v,
                                        tex_filter, need_i, tex_u)
            else:
                img = _image_eval(scene, shade.image_id, u, v, tex_filter,
                                  tex_u)
            return V.where(need_i, img, a)

        albedo = lax.cond(jnp.any(need_i), _image, lambda a: a, albedo)

    return albedo
