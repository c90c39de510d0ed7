"""Structure-of-arrays 3-vectors: the data-parallel layout for ray wavefronts.

A `[N, 3]` array puts the three components of one ray next to each other,
so elementwise ray math reads strided rows.  The layout here is
component-planar: three dense `[N]` arrays with the *ray* axis contiguous,
so every elementwise op streams whole planes (coalesced on a GPU).

`Vec3` packages the three planes with vector-calculus ergonomics.  It is a
NamedTuple, hence automatically a JAX pytree: it can flow through `jit`,
`lax.scan`/`while_loop` carries, `vmap`, and `grad` untouched.

This replaces float3/sutil vec_math of the reference
(RestOfLife/lib/vector_utils.cuh and the sutil headers) — but where the
reference's float3 is a per-thread register triple, Vec3's components are
whole-wavefront planes.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp


class Vec3(NamedTuple):
    x: Any
    y: Any
    z: Any

    # -- arithmetic (component-wise; scalars and [N] arrays broadcast) -----
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- geometry -----------------------------------------------------------
    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm2(self):
        return self.dot(self)

    def length(self):
        # clamped away from 0 so reverse-mode |a| at a=0 stays finite
        return jnp.sqrt(jnp.maximum(self.norm2(), 1e-30))

    def normalized(self) -> "Vec3":
        return self * (1.0 / self.length())

    def max_component(self):
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def abs(self) -> "Vec3":
        return Vec3(jnp.abs(self.x), jnp.abs(self.y), jnp.abs(self.z))

    # -- conversion ----------------------------------------------------------
    def stack(self):
        """To [N, 3] (or [3]) array — boundary use only, never in hot loops."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    @property
    def shape(self):
        return jnp.shape(self.x)


def v3(x, y=None, z=None) -> Vec3:
    """Construct from components, a length-3 sequence, or an [..., 3] array."""
    if y is None:
        a = x
        if isinstance(a, Vec3):
            return a
        if isinstance(a, (tuple, list)):
            return Vec3(*(jnp.asarray(c, jnp.float32) for c in a))
        a = jnp.asarray(a)
        return Vec3(a[..., 0], a[..., 1], a[..., 2])
    return Vec3(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                jnp.asarray(z, jnp.float32))


def full_like(ref, cx, cy, cz) -> Vec3:
    """Constant Vec3 broadcast to the [N] shape of `ref` (an array)."""
    return Vec3(jnp.full_like(ref, cx), jnp.full_like(ref, cy),
                jnp.full_like(ref, cz))


def zeros(n: int, dtype=jnp.float32) -> Vec3:
    return Vec3(jnp.zeros(n, dtype), jnp.zeros(n, dtype), jnp.zeros(n, dtype))


def ones(n: int, dtype=jnp.float32) -> Vec3:
    return Vec3(jnp.ones(n, dtype), jnp.ones(n, dtype), jnp.ones(n, dtype))


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    """Component-wise select by a [N] (or scalar) bool mask."""
    return Vec3(jnp.where(mask, a.x, b.x), jnp.where(mask, a.y, b.y),
                jnp.where(mask, a.z, b.z))


def dot(a: Vec3, b: Vec3):
    return a.dot(b)


def cross(a: Vec3, b: Vec3) -> Vec3:
    return a.cross(b)


def normalize(a: Vec3) -> Vec3:
    return a.normalized()


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """Mirror reflection; expects unit inputs (matches sutil reflect)."""
    return d - n * (2.0 * d.dot(n))


def gather_rows(arr, idx) -> Vec3:
    """Vec3 from rows of an [R, 3] table gathered by int [N] indices.

    Three 1-D gathers from pre-sliced [R] columns (the column slices of a
    scene-constant table are hoisted out of the loop by XLA), which keeps
    the result SoA without a 2-D row gather and a transpose.

    When the table has exactly one row the gather vanishes entirely
    (broadcast of row 0) — the common case for the reference scenes' single
    area light.
    """
    if arr.shape[0] == 1:
        n = jnp.shape(idx)
        return Vec3(jnp.broadcast_to(arr[0, 0], n),
                    jnp.broadcast_to(arr[0, 1], n),
                    jnp.broadcast_to(arr[0, 2], n))
    return Vec3(arr[:, 0][idx], arr[:, 1][idx], arr[:, 2][idx])


def affine_point(m, p: Vec3) -> Vec3:
    """Apply a single [3, 4] affine to a Vec3 of [N] planes (or broadcast a
    [C]-batch: m rows indexable as m[i][j] arrays)."""
    return Vec3(
        m[0][0] * p.x + m[0][1] * p.y + m[0][2] * p.z + m[0][3],
        m[1][0] * p.x + m[1][1] * p.y + m[1][2] * p.z + m[1][3],
        m[2][0] * p.x + m[2][1] * p.y + m[2][2] * p.z + m[2][3],
    )


def affine_vec(m, v: Vec3) -> Vec3:
    return Vec3(
        m[0][0] * v.x + m[0][1] * v.y + m[0][2] * v.z,
        m[1][0] * v.x + m[1][1] * v.y + m[1][2] * v.z,
        m[2][0] * v.x + m[2][1] * v.y + m[2][2] * v.z,
    )
