"""Pallas-Triton trace kernels for the GPU: nearest-hit and any-hit sweeps.

The plain-XLA sweep (ops/intersect.py) scans the scene in prim blocks with
`lax.scan`; on the GPU every scan step is its own fusion that re-reads the
ray planes and the running (t, prim) carry from device memory.  Here one
Triton program owns a block of `RAY_BLOCK` rays, keeps them and the carry
in registers for the whole scene, and writes only `(best_t, best_prim)`:

- one thread per ray; primitives are visited one at a time with uniform
  scalar loads from the props table (at most a few hundred KB, so it stays
  in L2 for every program);
- each builder block (models/builder.py chunk plan) is guarded by a
  warp-uniform branch on its world AABB: a block no ray of the program can
  reach (or, for the nearest-hit sweep, reach before its current best) is
  skipped whole (without this cull the kernel measured 3-5x slower on the
  1410-prim TNW scene, PERF.md);
- the any-hit sweep drops rays from its pending set on their first hit, so
  blocks are skipped once every ray of the program is occluded.

The per-type tests are the ops/intersect.py callees (`sphere_t`, `rect_t`,
...) called with scalar params, so the geometry has one definition.  The
winner's payload (point, normal, uv) and shading record stay in XLA
(`intersect.winner_hit` / `reeval_hit`, `shading.gather_shade`).
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from rtw.models import scene as S
from rtw.ops import intersect as I
from rtw.ops import vec as V
from rtw.ops.vec import Vec3

BIG = I.BIG
RAY_BLOCK = 128        # rays per Triton program (one per thread)
NUM_WARPS = 4

_INTERPRET = False


@contextlib.contextmanager
def interpret_mode():
    """Run the kernels through the Pallas interpreter (CPU tests only)."""
    global _INTERPRET
    prev, _INTERPRET = _INTERPRET, True
    try:
        yield
    finally:
        _INTERPRET = prev


def kernel_available() -> bool:
    """The kernels compile for a GPU, or the tests' interpreter is on."""
    return _INTERPRET or jax.default_backend() == "gpu"


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _prim_t(ptype, axis, has_xform, props_ref, p, o, d, tmin, tmax, time,
            u):
    """[RAY_BLOCK] t of prim row `p` (BIG on miss)."""
    params = [props_ref[p, k] for k in range(S.NUM_PRIM_PARAMS)]
    if has_xform:
        m = [[props_ref[p, S.NUM_PRIM_PARAMS + i * 4 + j] for j in range(4)]
             for i in range(3)]
        o, d = V.affine_point(m, o), V.affine_vec(m, d)
    if ptype == S.PRIM_SPHERE:
        return I.sphere_t(params, o, d, tmin, tmax)
    if ptype == S.PRIM_MOVING_SPHERE:
        return I.moving_sphere_t(params, o, d, tmin, tmax, time)
    if ptype == S.PRIM_RECT:
        return I.rect_t(params, o, d, tmin, tmax, axis)
    if ptype == S.PRIM_BOX:
        return I.box_t(params, o, d, tmin, tmax)
    if ptype == S.PRIM_VOLUME_SPHERE:
        return I.volume_sphere_t(params, o, d, tmin, tmax, u)
    if ptype == S.PRIM_VOLUME_BOX:
        return I.volume_box_t(params, o, d, tmin, tmax, u)
    raise ValueError(f"unknown prim type {ptype}")  # pragma: no cover


def _block_reach(aabb_ref, b, o, d, tmin, tmax):
    """Per-ray entry distance into block `b`'s world AABB (BIG where the
    ray cannot reach the box inside (tmin, tmax))."""
    near = jnp.full_like(o.x, -BIG)
    far = jnp.full_like(o.x, BIG)
    for ax in range(3):
        inv = 1.0 / jnp.where(d[ax] == 0.0, 1e-30, d[ax])
        t0 = (aabb_ref[b, ax] - o[ax]) * inv
        t1 = (aabb_ref[b, 3 + ax] - o[ax]) * inv
        near = jnp.maximum(near, jnp.minimum(t0, t1))
        far = jnp.minimum(far, jnp.maximum(t0, t1))
    near = jnp.maximum(near, tmin)
    return jnp.where((far >= near) & (near < tmax), near, BIG)


def _any(mask):
    return jnp.max(mask.astype(jnp.int32)) > 0


def _sweep(plan, vol_slots, tmin, visit, skip, carry, rays_ref, vu_ref,
           props_ref, aabb_ref):
    """Visit every real prim of the chunk plan in order.

    `visit(carry, p, t)` folds prim row `p`'s t-vector into the carry;
    `skip(carry, reach)` says (warp-uniformly) that no ray of the program
    can gain from a block with per-ray entry distances `reach`."""
    o = Vec3(rays_ref[0, :], rays_ref[1, :], rays_ref[2, :])
    d = Vec3(rays_ref[3, :], rays_ref[4, :], rays_ref[5, :])
    time = rays_ref[6, :]
    tmax = rays_ref[7, :]

    blk0 = 0
    for start, count, size, ptype, axis, has_xform, block in plan:
        n_blocks = size // block
        test = functools.partial(_prim_t, ptype, axis, has_xform, props_ref)
        if ptype in (S.PRIM_VOLUME_SPHERE, S.PRIM_VOLUME_BOX):
            # a handful of prims, each with its own static uniform row
            for p in range(start, start + count):
                u = vu_ref[max(vol_slots[p], 0), :]
                carry = visit(carry, p, test(p, o, d, tmin, tmax, time, u))
            blk0 += n_blocks
            continue

        def prims(k, c, b, start=start, count=count, block=block,
                  test=test):
            p = start + b * block + k
            t = test(p, o, d, tmin, tmax, time, None)
            return visit(c, p, jnp.where(b * block + k < count, t, BIG))

        def run_block(b, c, block=block, prims=prims):
            return lax.fori_loop(0, block, functools.partial(prims, b=b), c)

        def one_block(b, c, blk0=blk0, run_block=run_block):
            reach = _block_reach(aabb_ref, blk0 + b, o, d, tmin, tmax)
            return lax.cond(skip(c, reach), lambda c: c,
                            functools.partial(run_block, b), c)

        carry = lax.fori_loop(0, n_blocks, one_block, carry)
        blk0 += n_blocks
    return carry


def _nearest_body(plan, vol_slots, tmin, rays_ref, vu_ref, props_ref,
                  aabb_ref, t_ref, i_ref):
    n = t_ref.shape[0]

    def visit(c, p, t):
        bt, bi = c
        better = t < bt
        return jnp.where(better, t, bt), jnp.where(better, p, bi)

    def skip(c, reach):
        return ~_any(reach < c[0])

    init = (jnp.full((n,), BIG, jnp.float32), jnp.full((n,), -1, jnp.int32))
    bt, bi = _sweep(plan, vol_slots, tmin, visit, skip, init, rays_ref,
                    vu_ref, props_ref, aabb_ref)
    t_ref[...] = bt
    i_ref[...] = bi


def _occluded_body(plan, vol_slots, tmin, rays_ref, vu_ref, props_ref,
                   aabb_ref, occ_ref):
    n = occ_ref.shape[0]

    def visit(occ, p, t):
        return occ | (t < BIG).astype(jnp.int32)

    def skip(occ, reach):
        return ~_any((occ == 0) & (reach < BIG))

    occ = _sweep(plan, vol_slots, tmin, visit, skip,
                 jnp.zeros((n,), jnp.int32), rays_ref, vu_ref, props_ref,
                 aabb_ref)
    occ_ref[...] = occ


@functools.lru_cache(maxsize=64)
def _make_call(kind, plan, vol_slots, tmin, n_pad, nvp, interpret):
    body = _nearest_body if kind == "nearest" else _occluded_body
    kern = functools.partial(body, plan, vol_slots, tmin)
    ray_spec = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    if kind == "nearest":
        out_specs = (ray_spec, ray_spec)
        out_shape = (jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                     jax.ShapeDtypeStruct((n_pad,), jnp.int32))
    else:
        out_specs = ray_spec
        out_shape = jax.ShapeDtypeStruct((n_pad,), jnp.int32)

    def run(rays, vu, props, aabbs):
        return pl.pallas_call(
            kern,
            grid=(n_pad // RAY_BLOCK,),
            in_specs=[
                pl.BlockSpec((8, RAY_BLOCK), lambda i: (0, i)),
                pl.BlockSpec((nvp, RAY_BLOCK), lambda i: (0, i)),
                pl.BlockSpec(props.shape, lambda i: (0, 0)),
                pl.BlockSpec(aabbs.shape, lambda i: (0, 0)),
            ],
            out_specs=out_specs,
            out_shape=out_shape,
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
            interpret=interpret,
            name=f"trace_{kind}",
        )(rays, vu, props, aabbs)

    return run


def _launch(kind, scene: S.Scene, o: Vec3, d: Vec3, tmin, tmax, time, vol_u):
    if not kernel_available():
        raise ValueError(
            f"the trace kernels need a GPU (backend is "
            f"{jax.default_backend()!r}); use backend='jnp'")
    n = o.x.shape[0]
    n_pad = -(-n // RAY_BLOCK) * RAY_BLOCK
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (n,))
    rays = jnp.stack([o.x, o.y, o.z, d.x, d.y, d.z,
                      jnp.broadcast_to(time, (n,)), tmax])
    nvp = _pow2(vol_u.shape[0])
    # padded rays are dead (tmax = -BIG) and padded uniform rows unused
    rays = jnp.pad(rays, ((0, 0), (0, n_pad - n)))
    rays = rays.at[7, n:].set(-BIG)
    vu = jnp.pad(vol_u, ((0, nvp - vol_u.shape[0]), (0, n_pad - n)))
    pr = scene.prims
    props = pr.params
    if any(e[5] for e in scene.chunk_plan):
        props = jnp.concatenate(
            [props, pr.w2o.reshape(props.shape[0], 12)], axis=1)
    run = _make_call(kind, scene.chunk_plan, scene.vol_slots_static,
                     float(tmin), n_pad, nvp, _INTERPRET)
    out = run(rays, vu, props, scene.block_aabbs)
    return jax.tree_util.tree_map(lambda x: x[:n], out)


def nearest_pallas(scene: S.Scene, o: Vec3, d: Vec3, tmin, tmax, time,
                   vol_u):
    """(best_t, best_prim) of every ray — the kernel form of
    ops/intersect.nearest (same ties: the lowest prim row wins)."""
    return _launch("nearest", scene, o, d, tmin, tmax, time, vol_u)


def occluded_pallas(scene: S.Scene, o: Vec3, d: Vec3, tmin, tmax, time,
                    vol_u):
    """Any hit in (tmin, tmax) per ray — the kernel form of
    ops/intersect.occluded."""
    return _launch("occluded", scene, o, d, tmin, tmax, time, vol_u) > 0
