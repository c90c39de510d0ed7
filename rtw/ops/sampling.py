"""Sampling primitives + shading math on SoA wavefronts (differentiable-safe).

Re-derives the device math of the reference's lib/ (onb.cuh, sampling.cuh,
raydata.cuh:167-171) over `Vec3` component planes (ops/vec.py): every
function maps [N] uniform planes to [N]-component vectors, fully
lane-parallel.  Two deliberate divergences from the reference (SURVEY §7.4):

- quirk 4: `cosine_direction` uses the *correct* cosine-hemisphere formula
  (x = cos(phi)*sqrt(r2)) instead of the reference's book-v1 non-unit variant
  (sampling.cuh:49-60, x = cos(phi)*2*sqrt(r2)).
- rejection-free sphere sampling: the reference's `randomInUnitSphere`
  (sampling.cuh:25-34) loops until accept, which is unbounded work per lane;
  we draw exactly (z, phi, r) and map — identical distribution, fixed cost,
  which is what a lockstep wavefront wants.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from rtw.ops.vec import Vec3

PI = np.float32(np.pi)
INV_PI = np.float32(1.0 / np.pi)


def safe_sqrt(x, eps=1e-20):
    # clamped at eps (not 0) so reverse-mode never sees sqrt'(0)=inf; for
    # x < eps the maximum's zero-gradient kills the chain entirely.
    return jnp.sqrt(jnp.maximum(x, eps))


def power_heuristic(a, b):
    """MIS power heuristic, beta=2 (raydata.cuh:167-171)."""
    t = a * a
    return t / jnp.maximum(t + b * b, 1e-20)


def build_onb(n: Vec3):
    """Orthonormal basis from (unit) normal w; mirrors onb.cuh:20-32.

    Returns (u, v, w) with w = normalize(n).
    """
    w = n.normalized()
    big_x = jnp.abs(w.x) > 0.9
    ax = jnp.where(big_x, 0.0, 1.0)
    ay = jnp.where(big_x, 1.0, 0.0)
    a = Vec3(ax, ay, jnp.zeros_like(ax))
    v = w.cross(a).normalized()
    u = w.cross(v)
    return u, v, w


def onb_local(u: Vec3, v: Vec3, w: Vec3, a: Vec3) -> Vec3:
    """a.x*u + a.y*v + a.z*w (onb.cuh:12-18)."""
    return u * a.x + v * a.y + w * a.z


def cosine_direction(u1, u2) -> Vec3:
    """Cosine-weighted hemisphere direction in ONB-local coords; pdf = z/pi."""
    phi = 2.0 * PI * u1
    sr2 = safe_sqrt(u2)
    return Vec3(jnp.cos(phi) * sr2, jnp.sin(phi) * sr2, safe_sqrt(1.0 - u2))


def unit_disk(u1, u2):
    """Polar disk sample; matches random_in_unit_disk (sampling.cuh:15-22):
    a = u1*2pi, (sin a, cos a) * sqrt(u2).  Returns (dx, dy) planes."""
    a = u1 * 2.0 * PI
    r = safe_sqrt(u2)
    return jnp.sin(a) * r, jnp.cos(a) * r


def sphere_surface(u1, u2) -> Vec3:
    """Uniform direction on the unit sphere."""
    z = 1.0 - 2.0 * u1
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * u2
    return Vec3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def unit_ball(u1, u2, u3) -> Vec3:
    """Uniform point in the unit ball (replaces rejection sampling)."""
    return sphere_surface(u1, u2) * jnp.cbrt(jnp.maximum(u3, 1e-30))


def fresnel_schlick(cos_theta_i, eta_i, eta_t):
    """Schlick reflectance (dielectricMaterial.cu:21-27)."""
    r0 = (eta_i - eta_t) / (eta_i + eta_t)
    r0 = r0 * r0
    m = jnp.clip(1.0 - cos_theta_i, 0.0, 1.0)
    return r0 + (1.0 - r0) * (m ** 5)


def offset_point(point: Vec3, normal: Vec3, out_dir: Vec3, eps=1e-4) -> Vec3:
    """Scale-aware self-intersection offset: nudge a hit point along the
    geometric normal toward the side the outgoing ray leaves on.

    The reference relies on tiny absolute epsilons (tmin=1e-6 raygen.cu:46,
    shadow 5e-5 closehit.cu:100) which are smaller than fp32 hit-point error
    on large geometry (a radius-1000 sphere carries ~1e-4 absolute error) —
    producing shadow acne that its denoiser hides.  We offset by
    eps * max(1, |p|) instead, the standard robust construction."""
    scale = eps * jnp.maximum(1.0, point.abs().max_component())
    side = jnp.sign(normal.dot(out_dir))
    return point + normal * (scale * side)
