"""Post-process denoiser — edge-avoiding À-Trous wavelet filtering.

The reference runs every frame through the closed-source OptiX LDR neural
denoiser (RestOfLife/Director.cpp:887-949, 986-997) so its raygen can trace
a single sample per pixel (raygen.cu:133-147).  That network cannot be
ported; this framework restores the books' true multi-sample estimator and
offers a *classical* denoiser as an optional, clearly-non-parity
post-process (SURVEY §5 "Denoiser"): the edge-avoiding À-Trous wavelet
transform of Dammertz et al. (HPG 2010), the standard real-time filter that
SVGF and friends build on.

Guidance: the filter is driven by first-hit feature buffers (albedo and
shading normal) rendered by `primary_features` — one deterministic
center-of-pixel camera ray per pixel through the same intersection sweep the
renderer uses, i.e. the analog of the G-buffer the OptiX denoiser consumes
internally.  Everything is pure JAX on [H, W] planes: it runs jitted on the
device right after the accumulator, no host round-trip.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from rtw.models import scene as S
from rtw.ops import vec as V
from rtw.ops.intersect import intersect_scene
from rtw.ops.textures import eval_texture

# 5-tap B3-spline: the à-trous generating kernel
_B3 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def primary_features(scene: S.Scene, cfg):
    """First-hit G-buffer: (albedo [H,W,3], normal [H,W,3], hit [H,W]).

    Center-of-pixel rays, no lens offset, shutter mid-time — deterministic.
    """
    n = cfg.num_pixels
    pixel_idx = jnp.arange(n, dtype=jnp.int32)
    cam = scene.camera
    x = (pixel_idx % cfg.nx).astype(jnp.float32)
    y = (pixel_idx // cfg.nx).astype(jnp.float32)
    s = (x + 0.5) / np.float32(cfg.nx)
    t = (y + 0.5) / np.float32(cfg.ny)

    origin = V.v3(cam.origin)
    direction = (V.v3(cam.lower_left) + V.v3(cam.horizontal) * s
                 + V.v3(cam.vertical) * t - origin)
    origin = V.Vec3(*(jnp.broadcast_to(c, (n,)) for c in origin))
    time = jnp.full((n,), 0.5 * float(cam.time0 + cam.time1), jnp.float32)
    vol_u = jnp.full((max(scene.n_vol, 1), n), 0.5, jnp.float32)

    hit = intersect_scene(scene, origin, direction, cfg.t_min, cfg.t_max,
                          time, vol_u)
    albedo = eval_texture(scene.textures,
                          scene.materials.albedo_tex[hit.mat_id],
                          hit.u, hit.v, hit.point, scene.tex_present)
    mask = hit.prim_idx >= 0
    alb = V.where(mask, albedo, V.ones(n)).stack().reshape(cfg.ny, cfg.nx, 3)
    nrm = V.where(mask, hit.normal, V.zeros(n)).stack().reshape(
        cfg.ny, cfg.nx, 3)
    return alb, nrm, mask.reshape(cfg.ny, cfg.nx)


def _shift(img, dy: int, dx: int):
    """Edge-clamped shift: out[y, x] = img[clamp(y+dy), clamp(x+dx)]."""
    h, w = img.shape[0], img.shape[1]
    pad_y = (max(-dy, 0), max(dy, 0))
    pad_x = (max(-dx, 0), max(dx, 0))
    p = jnp.pad(img, [pad_y, pad_x] + [(0, 0)] * (img.ndim - 2), mode="edge")
    return p[pad_y[0] + dy: pad_y[0] + dy + h,
             pad_x[0] + dx: pad_x[0] + dx + w]


@functools.partial(jax.jit, static_argnames=("iterations",))
def atrous(img, albedo=None, normal=None, iterations: int = 5,
           sigma_color: float = 0.5, sigma_albedo: float = 0.13,
           sigma_normal: float = 0.25):
    """Edge-avoiding à-trous wavelet filter (Dammertz et al. 2010).

    img: [H, W, 3].  Optional guidance buffers from `primary_features`.
    Each iteration applies the 5x5 B3 kernel with holes (step 2^i) weighted
    by color/albedo/normal similarity; the color sigma halves per iteration
    as in the paper.  The color distance is Weber-normalized (relative to
    local brightness) so HDR fireflies don't disable the filter around
    themselves.
    """
    img = jnp.asarray(img, jnp.float32)
    out = img
    sc = sigma_color
    for it in range(iterations):
        step = 1 << it
        acc = jnp.zeros_like(out)
        wsum = jnp.zeros(out.shape[:2] + (1,), jnp.float32)
        inv_2sc2 = 1.0 / (2.0 * sc * sc)
        for ky in range(5):
            for kx in range(5):
                dy = (ky - 2) * step
                dx = (kx - 2) * step
                h = _B3[ky] * _B3[kx]
                c = _shift(out, dy, dx)
                scale = jnp.sum(out + c, axis=-1, keepdims=True) + 1e-2
                d2 = jnp.sum((out - c) ** 2, axis=-1, keepdims=True) \
                    / (scale * scale)
                w = h * jnp.exp(-d2 * inv_2sc2)
                if albedo is not None:
                    da = jnp.sum((albedo - _shift(albedo, dy, dx)) ** 2,
                                 axis=-1, keepdims=True)
                    w = w * jnp.exp(-da / (2.0 * sigma_albedo ** 2))
                if normal is not None:
                    dn = jnp.sum((normal - _shift(normal, dy, dx)) ** 2,
                                 axis=-1, keepdims=True)
                    w = w * jnp.exp(-dn / (2.0 * sigma_normal ** 2))
                acc = acc + w * c
                wsum = wsum + w
        out = acc / jnp.maximum(wsum, 1e-8)
        sc = sc * 0.5
    return out


def denoise(img, scene: S.Scene = None, cfg=None, iterations: int = 5,
            mode: str = "ldr", gamma: float = 2.0):
    """Denoise a render; with (scene, cfg) the first-hit G-buffer guides the
    edge-stopping functions (recommended).

    mode="ldr" (default) filters in display space (clamp + gamma), matching
    the *LDR* semantics of the reference's denoiser
    (OPTIX_DENOISER_MODEL_KIND_LDR, Director.cpp:891) — it both matches the
    reference's pipeline position and is robust to HDR fireflies; the
    returned image is display-space in [0, 1] (feed to `to_srgb8` with
    gamma=1).  mode="hdr" filters the linear radiance directly and returns
    linear values.
    """
    alb = nrm = None
    if scene is not None and cfg is not None:
        alb, nrm, _ = primary_features(scene, cfg)
    if mode == "ldr":
        disp = jnp.clip(jnp.asarray(img), 0.0, 1.0) ** (1.0 / gamma)
        return atrous(disp, albedo=alb, normal=nrm, iterations=iterations)
    if mode == "hdr":
        return atrous(img, albedo=alb, normal=nrm, iterations=iterations)
    raise ValueError(f"mode must be 'ldr' or 'hdr', got {mode!r}")
