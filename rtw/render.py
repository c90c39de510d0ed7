"""Top-level render driver: spp accumulation, ray tiling, image assembly.

Replaces Director::renderFrame + printPPM (Director.cpp:971-1031), restoring
the books' true multi-sample estimator: `spp` is a live accumulation loop
(the reference traces 1 spp and denoises, raygen.cu:133-147 — SURVEY §7.4
quirk 1; we do not port the closed OptiX NN denoiser, §5).

Gamma is applied only at image write, on the converged linear accumulator
(the reference applies sqrt per 1-spp frame *before* denoising, quirk 12).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import sys as _sys
import time as _time

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from rtw.integrator import check_backend, trace_wavefront
from rtw.utils import rng as R


def device_info() -> dict:
    """The device a render ran on, as JAX reports it."""
    dev = jax.devices()[0]
    return dict(platform=dev.platform, device_kind=dev.device_kind,
                device_count=len(jax.devices()))


@functools.lru_cache(maxsize=8)
def tile_permutation(nx: int, ny: int, tile: int = 32) -> np.ndarray:
    """Pixel visit order that groups `tile`x`tile` image tiles into
    contiguous lane runs, so every ray block a trace-kernel program owns
    (ops/trace_kernel.RAY_BLOCK rays) is a spatially compact pixel
    footprint instead of a slice of one raster row.

    Why it matters: the kernels cull whole primitive blocks per ray block
    by AABB (and by best-t) — a cull only fires when EVERY ray in the block
    agrees, which needs the block's rays to share a frustum.  Primary rays
    of a raster row fan across the whole image width and defeat the cull;
    a tile's rays (and, because ray regeneration keeps each lane pinned to
    its pixel, all its bounce-ray origins) stay localized for the whole
    render.

    Lane i renders pixel `perm[i]`; invert by scattering lane values to
    `perm` (render() does).  Pure relabeling: per-pixel estimates are keyed
    by logical pixel id, so the image is bit-identical to raster order.

    Cached and read-only: the sort takes about 0.1 s of host time at
    800x800, outside render()'s timer but inside every call's wall time."""
    y, x = np.mgrid[0:ny, 0:nx]
    y, x = y.ravel(), x.ravel()
    perm = np.lexsort((x % tile, y % tile, x // tile, y // tile))
    perm = perm.astype(np.int32)
    perm.flags.writeable = False
    return perm


@functools.partial(jax.jit, static_argnums=(1, 4), donate_argnums=(5,))
def _render_tile(scene, cfg, pixel_idx, key, n_samples, accum, s0):
    """Accumulate `n_samples` samples (starting at index s0) for one tile via
    the persistent regenerating wavefront (integrator.trace_wavefront).
    accum = (radiance_sum [N,3], ray_count scalar, stats pytree)."""
    acc_v, rays, stats = trace_wavefront(scene, cfg, pixel_idx, key, s0,
                                         n_samples)
    stats_acc = (jax.tree_util.tree_map(jnp.add, accum[2], stats)
                 if cfg.bounce_stats else ())
    return accum[0] + acc_v.stack(), accum[1] + rays, stats_acc


def render(scene, cfg, key=None, verbose: bool = False,
           metrics: dict | None = None, checkpoint_path: str | None = None,
           checkpoint_every: int = 0):
    """Render and return the *linear* [ny, nx, 3] float32 image (row 0 at the
    bottom, i.e. t=0 — the reference's frame-buffer convention,
    raygen.cu:156-158).

    With `checkpoint_path` set, the accumulator is persisted every
    `checkpoint_every` samples (default: every spp chunk) and a matching
    checkpoint is resumed from, continuing the deterministic sample stream
    (utils/checkpoint.py) — the render is bit-identical to an uninterrupted
    one."""
    if key is None:
        key = R.base_key(cfg.seed)
    check_backend(cfg, scene)

    npix = cfg.num_pixels
    batch = cfg.resolved_ray_batch()
    chunk = cfg.resolved_spp_chunk(checkpointing=checkpoint_path is not None)
    n_tiles = math.ceil(npix / batch)
    pad = n_tiles * batch - npix
    perm = tile_permutation(cfg.nx, cfg.ny)    # lane i renders pixel perm[i]
    pixel_idx = jnp.asarray(np.concatenate(
        [perm, np.zeros(pad, np.int32)]))      # padded lanes recompute pixel 0
    perm_j = jnp.asarray(perm)
    # whole image in one batch: the lane -> pixel map IS tile_permutation, so
    # the work-queue flush can decode pixels arithmetically (config.py
    # pixel_layout; integrator.decode_tile_pixel)
    if n_tiles == 1 and pad == 0 and cfg.pixel_layout == "generic":
        cfg = dataclasses.replace(cfg, pixel_layout="tile32")

    from rtw.integrator import _stats_zero

    stats0 = (_stats_zero(cfg.max_depth, cfg.occupancy_trace)
              if cfg.bounce_stats else ())
    accums = [(jnp.zeros((batch, 3), jnp.float32),
               jnp.zeros((), jnp.float32), stats0) for _ in range(n_tiles)]
    spp_done = 0
    if checkpoint_path is not None:
        from rtw.utils import checkpoint as ckpt

        state = ckpt.load(checkpoint_path, cfg)
        if state is not None:
            acc_np, rays0, spp_done = state
            per = np.zeros((n_tiles * batch, 3), np.float32)
            per[: acc_np.shape[0]] = acc_np
            accums = [(jnp.asarray(per[i * batch:(i + 1) * batch]),
                       jnp.zeros((), jnp.float32), stats0)
                      for i in range(n_tiles)]
            accums[0] = (accums[0][0], jnp.asarray(rays0, jnp.float32),
                         stats0)
            if verbose:
                # stderr: stdout is the image sink (printPPM convention,
                # Director.cpp:1010-1031 — logs go to stderr)
                print(f"INFO: resumed at {spp_done}/{cfg.spp} spp",
                      file=_sys.stderr, flush=True)

    t_start = _time.perf_counter()
    s0 = spp_done
    last_ckpt = spp_done
    while s0 < cfg.spp:
        ns = min(chunk, cfg.spp - s0)
        for ti in range(n_tiles):
            tile_pix = lax.dynamic_slice_in_dim(pixel_idx, ti * batch, batch)
            accums[ti] = _render_tile(scene, cfg, tile_pix, key, ns,
                                      accums[ti], jnp.asarray(s0, jnp.int32))
        s0 += ns
        if verbose:
            jax.block_until_ready(accums[-1][0])
            print(f"INFO: {s0}/{cfg.spp} spp done", file=_sys.stderr,
                  flush=True)
        # checkpoint whenever >= checkpoint_every samples accumulated since
        # the last save (not an exact-multiple test: spp chunks need not
        # divide checkpoint_every), and always at the end
        if checkpoint_path is not None and (
                s0 >= cfg.spp or checkpoint_every <= 0
                or s0 - last_ckpt >= checkpoint_every):
            from rtw.utils import checkpoint as ckpt

            acc_np = np.concatenate([np.asarray(a[0]) for a in accums])[:npix]
            rays_np = float(sum(float(a[1]) for a in accums))
            ckpt.save(checkpoint_path, cfg, acc_np, rays_np, s0)
            last_ckpt = s0

    lanes = jnp.concatenate([a[0] for a in accums], axis=0)[:npix]
    # un-permute tile order back to raster order (lane i holds pixel perm[i])
    img = (jnp.zeros((npix, 3), jnp.float32).at[perm_j].set(lanes)
           / np.float32(cfg.spp))
    img = jax.block_until_ready(img)
    total_rays = sum(float(a[1]) for a in accums)
    elapsed = _time.perf_counter() - t_start

    if metrics is not None:
        n_paths = npix * (cfg.spp - spp_done)
        metrics.update(
            wall_seconds=elapsed,
            pixels=npix,
            spp=cfg.spp,
            paths=n_paths,
            rays=total_rays,
            samples_per_sec=n_paths / max(elapsed, 1e-9),
            mrays_per_sec=total_rays / max(elapsed, 1e-9) / 1e6,
            **device_info(),
        )
        if cfg.bounce_stats:
            st = accums[0][2]
            for a in accums[1:]:
                st = jax.tree_util.tree_map(jnp.add, st, a[2])
            st = jax.tree_util.tree_map(np.asarray, st)
            # rays_by_depth[d] = paths that traced a ray at depth d
            #                  = sum over lengths L > d of len_hist[L]
            tail = np.cumsum(st.len_hist[::-1])[::-1]
            metrics.update(
                rays_by_depth=[float(x) for x in tail[1:]],
                wavefront_iterations=float(st.iters),
                # mean alive-lane fraction across all wavefront iterations
                mean_occupancy=float(st.alive_sum)
                / max(float(st.iters) * batch, 1.0),
                # mean alive lanes at iteration i of a jitted step (the
                # regeneration plateau and the drain-tail decay are visible
                # here; iterations beyond the trace cap accumulate into the
                # last entry)
                occupancy_by_iter=[
                    float(s / c) / batch
                    for s, c in zip(st.occ_sum, st.occ_cnt)
                    if c >= 1.0],
            )

    return img.reshape(cfg.ny, cfg.nx, 3)


def to_srgb8(linear_img, gamma: float = 2.0):
    """Clamp + gamma -> uint8, top row first (printPPM writes bottom-up from
    a bottom-origin buffer, Director.cpp:1014-1029 — same final orientation).
    Quantization runs in the native C++ module when available."""
    from rtw.utils.native import srgb_encode

    img = srgb_encode(np.asarray(linear_img), gamma)
    return img[::-1]  # flip to top-row-first image convention


def render_image(scene, cfg, key=None, verbose=False, metrics=None):
    """Render to a gamma-corrected uint8 [ny, nx, 3] image (top row first)."""
    return to_srgb8(render(scene, cfg, key, verbose, metrics), cfg.gamma)
