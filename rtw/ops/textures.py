"""Texture evaluation — masked lockstep replacement for the reference's
texture direct-callables (texture/*.cu).

All textures for a ray wavefront are evaluated branch-free: every type's
value is computed for every lane and the per-lane type id selects.  Checker
(one nesting level) gathers its children's ids and evaluates them as leaves,
mirroring the recursive optixDirectCall in checkeredTexture.cu while staying
a static two-level dataflow.  Colors are Vec3 component planes (ops/vec.py).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from rtw.models import scene as S
from rtw.ops import vec as V
from rtw.ops.vec import Vec3
from rtw.utils.rng import pcg_hash, _to_unit


def _lattice_gradient(ix, iy, iz) -> Vec3:
    """Unit gradient at an integer lattice point from chained pcg_hash.

    Replaces the reference's ranvec[perm_x[i]^perm_y[j]^perm_z[k]] table
    scheme (texture/ioTexture.h:118-219, noiseTexture.cu:18-53): the
    8-corner x 7-octave turbulence would issue ~168 per-lane gathers per
    bounce, while hash arithmetic is pure elementwise work.  The
    reference's own tables
    are mt19937-seeded (already a documented divergence, QUIRKS.md #20);
    any valid random-unit-gradient lattice is an equally correct Perlin.
    """
    h = pcg_hash(ix.astype(jnp.uint32)
                 + pcg_hash(iy.astype(jnp.uint32)
                            + pcg_hash(iz.astype(jnp.uint32))))
    gx = _to_unit(h) * 2.0 - 1.0
    gy = _to_unit(pcg_hash(h + np.uint32(1))) * 2.0 - 1.0
    gz = _to_unit(pcg_hash(h + np.uint32(2))) * 2.0 - 1.0
    inv = jax.lax.rsqrt(gx * gx + gy * gy + gz * gz + 1e-12)
    return Vec3(gx * inv, gy * inv, gz * inv)


def perlin_noise(tex: S.Textures, p: Vec3):
    """Trilinear gradient Perlin noise (noiseTexture.cu:18-53), batched.

    p: Vec3 of [N] planes -> [N] in [-1, 1]-ish.  `tex` is accepted for API
    symmetry; gradients come from `_lattice_gradient` (see there).
    """
    fx, fy, fz = jnp.floor(p.x), jnp.floor(p.y), jnp.floor(p.z)
    ux, uy, uz = p.x - fx, p.y - fy, p.z - fz
    i = fx.astype(jnp.int32)
    j = fy.astype(jnp.int32)
    k = fz.astype(jnp.int32)

    # hermite smooth per axis
    sx = ux * ux * (3.0 - 2.0 * ux)
    sy = uy * uy * (3.0 - 2.0 * uy)
    sz = uz * uz * (3.0 - 2.0 * uz)

    accum = jnp.zeros_like(p.x)
    for di in range(2):
        wx = sx if di else (1.0 - sx)
        wxd = ux - di
        for dj in range(2):
            wy = sy if dj else (1.0 - sy)
            wyd = uy - dj
            for dk in range(2):
                g = _lattice_gradient(i + di, j + dj, k + dk)
                wz = sz if dk else (1.0 - sz)
                dot = g.x * wxd + g.y * wyd + g.z * (uz - dk)
                accum = accum + (wx * wy * wz) * dot
    return accum


def turbulence(tex: S.Textures, p: Vec3, octaves: int = 7):
    """7-octave turbulence (noiseTexture.cu:56-69)."""
    accum = jnp.zeros_like(p.x)
    weight = 1.0
    tp = p
    for _ in range(octaves):
        accum = accum + weight * perlin_noise(tex, tp)
        weight *= 0.5
        tp = tp * 2.0
    return jnp.abs(accum)


def _image_geometry(tex: S.Textures, image_id):
    """Per-lane (h, w, offset) of each lane's image WITHOUT per-lane table
    gathers: scenes carry 1-4 images, so an unrolled masked select over the
    static table rows costs a few [N] elementwise selects instead of three
    per-lane gathers.  Falls back to gathers for implausibly many
    images."""
    n_img = tex.image_offset.shape[0]
    if n_img == 1:
        shp = image_id.shape
        return (jnp.broadcast_to(tex.image_dims[0, 0], shp),
                jnp.broadcast_to(tex.image_dims[0, 1], shp),
                jnp.broadcast_to(tex.image_offset[0], shp))
    if n_img <= 4:
        h_i = jnp.broadcast_to(tex.image_dims[0, 0], image_id.shape)
        w_i = jnp.broadcast_to(tex.image_dims[0, 1], image_id.shape)
        off = jnp.broadcast_to(tex.image_offset[0], image_id.shape)
        for r in range(1, n_img):
            sel = image_id == r
            h_i = jnp.where(sel, tex.image_dims[r, 0], h_i)
            w_i = jnp.where(sel, tex.image_dims[r, 1], w_i)
            off = jnp.where(sel, tex.image_offset[r], off)
        return h_i, w_i, off
    return (tex.image_dims[:, 0][image_id], tex.image_dims[:, 1][image_id],
            tex.image_offset[image_id])


def _image_bilinear(tex: S.Textures, image_id, u, v) -> Vec3:
    """Normalized-coordinate bilinear fetch with clamp addressing — the
    explicit form of the reference's cudaTextureObject_t setup
    (ioTexture.h:293-311: clamp, linear filter, normalized floats).

    4 flat uint32 gathers from the RGB8-packed atlas + bit unpack (see
    Textures.images_packed); per-image dims/offset resolve gather-free
    (_image_geometry)."""
    h_i, w_i, off = _image_geometry(tex, image_id)
    h = h_i.astype(jnp.float32)
    w = w_i.astype(jnp.float32)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0

    inv255 = np.float32(1.0 / 255.0)

    def fetch(xi, yi) -> Vec3:
        xi = jnp.clip(xi, 0, w_i - 1)
        yi = jnp.clip(yi, 0, h_i - 1)
        bits = tex.images_packed[off + yi * w_i + xi]     # one 1-D gather
        m = np.uint32(0xFF)
        return Vec3(
            (bits & m).astype(jnp.float32) * inv255,
            ((bits >> np.uint32(8)) & m).astype(jnp.float32) * inv255,
            ((bits >> np.uint32(16)) & m).astype(jnp.float32) * inv255,
        )

    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    c00 = fetch(x0i, y0i)
    c10 = fetch(x0i + 1, y0i)
    c01 = fetch(x0i, y0i + 1)
    c11 = fetch(x0i + 1, y0i + 1)
    cx0 = c00 + (c10 - c00) * fx
    cx1 = c01 + (c11 - c01) * fx
    return cx0 + (cx1 - cx0) * fy


def _image_bilinear_565(tex: S.Textures, image_id, u, v) -> Vec3:
    """Bilinear fetch from the RGB565 pair atlas: TWO flat gathers (rows y0
    and y1; each pair word carries texels x0 and x0+1) instead of the four
    of `_image_bilinear`.  ~1.5% color quantization (5/6/5 bits), the
    documented trade for halving the dominant gather cost (QUIRKS.md)."""
    h_i, w_i, off = _image_geometry(tex, image_id)
    h = h_i.astype(jnp.float32)
    w = w_i.astype(jnp.float32)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    # clamp addressing: left of column 0 both taps are texel 0 (the pair
    # word at x=0 holds texels 0 and 1, so zero the blend weight instead)
    fx = jnp.where(x0 < 0.0, 0.0, x - x0)
    fy = y - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w_i - 1)
    y0i = y0.astype(jnp.int32)

    inv31 = np.float32(1.0 / 31.0)
    inv63 = np.float32(1.0 / 63.0)

    def fetch_pair(yi):
        yi = jnp.clip(yi, 0, h_i - 1)
        bits = tex.images_packed565[off + yi * w_i + x0i]  # one 1-D gather
        def unpack(half):
            return Vec3(
                ((half >> np.uint32(11)) & np.uint32(31)).astype(jnp.float32) * inv31,
                ((half >> np.uint32(5)) & np.uint32(63)).astype(jnp.float32) * inv63,
                (half & np.uint32(31)).astype(jnp.float32) * inv31,
            )
        return unpack(bits & np.uint32(0xFFFF)), unpack(bits >> np.uint32(16))

    c00, c10 = fetch_pair(y0i)
    c01, c11 = fetch_pair(y0i + 1)
    cx0 = c00 + (c10 - c00) * fx
    cx1 = c01 + (c11 - c01) * fx
    return cx0 + (cx1 - cx0) * fy


def _image_stoch_565(tex: S.Textures, image_id, u, v, xi) -> Vec3:
    """Stochastic bilinear fetch from the RGB565 pair atlas: ONE flat
    gather per fetch.  The y texel row is SAMPLED by its bilinear weight
    (row y0 with probability 1-fy, row y0+1 with fy) using the dedicated
    per-lane uniform `xi`; the x blend stays exact (the pair word carries
    both x taps).  E[fetch] is EXACTLY the `_image_bilinear_565` value, so
    under Monte Carlo spp averaging this converges to the same image with
    negligible added variance (texel-difference scale, far below path
    noise) — the stochastic texture filtering trade standard in production
    path tracers, here buying back half the dominant per-lane gather
    cost.  `xi` must be independent
    of every estimator draw (it gets its own RNG slot) or the
    throughput-times-radiance product would bias."""
    h_i, w_i, off = _image_geometry(tex, image_id)
    h = h_i.astype(jnp.float32)
    w = w_i.astype(jnp.float32)
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = jnp.where(x0 < 0.0, 0.0, x - x0)    # clamp addressing (see _565)
    fy = y - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w_i - 1)
    yi = jnp.clip(y0.astype(jnp.int32) + (xi < fy).astype(jnp.int32),
                  0, h_i - 1)

    inv31 = np.float32(1.0 / 31.0)
    inv63 = np.float32(1.0 / 63.0)
    bits = tex.images_packed565[off + yi * w_i + x0i]  # one 1-D gather

    def unpack(half):
        return Vec3(
            ((half >> np.uint32(11)) & np.uint32(31)).astype(jnp.float32)
            * inv31,
            ((half >> np.uint32(5)) & np.uint32(63)).astype(jnp.float32)
            * inv63,
            (half & np.uint32(31)).astype(jnp.float32) * inv31,
        )

    c0 = unpack(bits & np.uint32(0xFFFF))
    c1 = unpack(bits >> np.uint32(16))
    return c0 + (c1 - c0) * fx


def _image_nearest_565(tex: S.Textures, image_id, u, v) -> Vec3:
    """Nearest-texel fetch from the RGB565 pair atlas: ONE flat gather per
    fetch (vs 2 bilinear-565 / 4 bilinear-rgb8).  Gathers are the dominant
    image-texture cost, so this is the documented quality-for-speed end of
    the cfg.tex_filter ladder:
    565 quantization plus point sampling."""
    h_i, w_i, off = _image_geometry(tex, image_id)
    xi = jnp.clip((u * w_i.astype(jnp.float32)).astype(jnp.int32),
                  0, w_i - 1)
    yi = jnp.clip((v * h_i.astype(jnp.float32)).astype(jnp.int32),
                  0, h_i - 1)
    bits = tex.images_packed565[off + yi * w_i + xi]   # one 1-D gather
    half = bits & np.uint32(0xFFFF)                    # texel xi is the low word
    return Vec3(
        ((half >> np.uint32(11)) & np.uint32(31)).astype(jnp.float32)
        * np.float32(1.0 / 31.0),
        ((half >> np.uint32(5)) & np.uint32(63)).astype(jnp.float32)
        * np.float32(1.0 / 63.0),
        (half & np.uint32(31)).astype(jnp.float32) * np.float32(1.0 / 31.0),
    )


def _eval_leaf(tex: S.Textures, tex_id, u, v, p: Vec3, present) -> Vec3:
    """Evaluate non-checker textures for per-lane ids. [N] -> Vec3 of [N].

    `present[TEX_*]` are static scene-specialization flags: branches for
    texture kinds the scene doesn't contain are not traced at all (e.g. the
    Cornell box never pays for 7-octave Perlin)."""
    ttype = tex.tex_type[tex_id]
    out = V.zeros(tex_id.shape[0])

    # constant (constantTexture.cu)
    out = V.where(ttype == S.TEX_CONSTANT, V.gather_rows(tex.color, tex_id),
                  out)

    # noise: marble = 0.5 * (1 + sin(scale*z + 5*turb(scale*p)))
    # (noiseTexture.cu:72-83)
    if present[S.TEX_NOISE]:
        scale = tex.scale[tex_id]
        m = 0.5 * (1.0 + jnp.sin(scale * p.z + 5.0 * turbulence(tex, p * scale)))
        out = V.where(ttype == S.TEX_NOISE, Vec3(m, m, m), out)

    # image (imageTexture.cu)
    if present[S.TEX_IMAGE]:
        img = _image_bilinear(tex, jnp.maximum(tex.image_id[tex_id], 0), u, v)
        out = V.where(ttype == S.TEX_IMAGE, img, out)

    # null -> zeros (nullTexture.cu); already the default
    return out


def eval_texture(tex: S.Textures, tex_id, u, v, p: Vec3,
                 present=(True,) * 5) -> Vec3:
    """Full texture evaluation with one checker nesting level.

    tex_id: int32 [N]; u, v: [N]; p: Vec3 of [N] world hit-point planes;
    present: Scene.tex_present static specialization flags.

    Checker uses the book-correct sines product sin(10x)sin(10y)sin(10z);
    the reference's `sinf(10.f - p.y)` is a typo (checkeredTexture.cu:10,
    SURVEY §7.4 quirk 10) and no live scene instantiates a checker.
    """
    ttype = tex.tex_type[tex_id]
    if present[S.TEX_CHECKER]:
        is_checker = ttype == S.TEX_CHECKER
        sines = (jnp.sin(10.0 * p.x) * jnp.sin(10.0 * p.y)
                 * jnp.sin(10.0 * p.z))
        child = jnp.where(sines < 0.0, tex.odd[tex_id], tex.even[tex_id])
        leaf_id = jnp.where(is_checker, child, tex_id)
    else:
        leaf_id = tex_id
    return _eval_leaf(tex, leaf_id, u, v, p, present)
