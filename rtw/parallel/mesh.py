"""Device mesh + sharded rendering.

This subsystem has **no counterpart in the reference** (single GPU, one
CUstream — Director.cpp:113); it is the distributed backend the north star
requires (SURVEY §2.4 ledger, §5 "Distributed communication backend").

Design (the renderer's instantiation of the mesh/sharding recipe):

- 1-D mesh over a `data` axis.  Two sharding strategies:
  * **pixel sharding** (the renderer's DP): each device owns a contiguous
    slab of pixels and traces its wavefronts end-to-end.  Scene/BVH arrays
    are replicated; zero cross-device traffic during the bounce loop; the
    only collective is the implicit all-gather of the final image.
  * **sample sharding** (the renderer's context/batch-split parallelism):
    every device renders the full pixel grid at spp/N samples and the
    accumulators are `psum`-reduced at the end.  Useful when the
    image is small but spp is large.
- RNG is keyed by logical (pixel, sample) only (utils/rng.py), so both
  strategies produce *bit-identical* images to the single-device render —
  asserted in tests/test_parallel.py on an 8-device CPU mesh.
- Gradient renders shard pixels and `psum` parameter gradients; XLA overlaps
  the reduction with the backward sweep (latency-hiding scheduler).
- TP/PP/EP/sequence-parallel have no analog in a path tracer: there is no
  inter-ray dependence to partition.  Documented out of scope (SURVEY §2.4).

Multi-host: `init_distributed()` wraps `jax.distributed.initialize`; each
host builds the same scene (replicated) and `render_sharded` runs under a
global mesh spanning all hosts' devices.
"""

from __future__ import annotations

import functools
import math
import sys as _sys
import time as _time

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

from rtw.integrator import (check_backend, trace_paths_counted,
                            trace_wavefront)
from rtw.render import device_info, tile_permutation
from rtw.utils import rng as R


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Multi-host bootstrap over DCN (jax.distributed).  No-op if
    single-process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(devices=None) -> Mesh:
    """1-D `data` mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), axis_names=("data",))


def _pad_to(n: int, m: int) -> int:
    return math.ceil(n / m) * m


def _put_sharded(arr: np.ndarray, mesh: Mesh, spec) -> jax.Array:
    """Place a host-replicated numpy array as a global sharded jax.Array.

    Single-process: plain device_put.  Multi-process (jax.distributed):
    device_put cannot target non-addressable shards, so each process
    materializes its addressable shards from the (identical) host copy."""
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(arr), sharding)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def _replicated_np(x: jax.Array, mesh: Mesh) -> np.ndarray:
    """Gather a `data`-sharded array to a host numpy copy on every process
    (an all-gather; the multi-process-safe np.asarray)."""
    rep = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))(x)
    return np.asarray(rep)


# The sharded steps are module-level jits (cfg, mesh and the chunk shape
# static) so repeated renders of one configuration reuse the compilation.

@functools.partial(jax.jit, static_argnums=(1, 2, 7), donate_argnums=(5,))
def _pixels_step(scene, cfg, mesh, key, pix, acc, s0, ns):
    def local(pix_local, acc_local):
        a, rays, _ = trace_wavefront(scene, cfg, pix_local, key, s0, ns)
        return acc_local + a.stack(), lax.psum(rays, "data")

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P()), check_vma=False,
    )(pix, acc)


@functools.partial(jax.jit, static_argnums=(1, 2, 7, 8), donate_argnums=(5,))
def _samples_step(scene, cfg, mesh, key, pixel_idx, acc, done, ns,
                  local_spp):
    def local(acc_local):
        dev = lax.axis_index("data")
        s_base = (dev * local_spp + done).astype(jnp.int32)
        # persistent regenerating wavefront over this device's sample range
        a, rays, _ = trace_wavefront(scene, cfg, pixel_idx, key, s_base, ns)
        return (acc_local + lax.psum(a.stack(), "data"),
                lax.psum(rays, "data"))

    return jax.shard_map(local, mesh=mesh, in_specs=(P(),),
                         out_specs=(P(), P()), check_vma=False)(acc)


def render_sharded(scene, cfg, mesh: Mesh, key=None, mode: str = "pixels",
                   metrics: dict | None = None, verbose: bool = False,
                   checkpoint_path: str | None = None,
                   checkpoint_every: int = 0):
    """Sharded render; returns the full linear [ny, nx, 3] image (replicated).

    mode="pixels": pixel slabs per device.  mode="samples": full image per
    device at spp/N samples each, psum-reduced.

    Both modes accumulate in the same spp chunks as the single-device
    `render()` (cfg.resolved_spp_chunk), so the pixels-mode image is
    *bit-identical* to it (identical per-lane addition order).  With
    `checkpoint_path` the replicated accumulator persists every
    `checkpoint_every` samples (default: every chunk) and resumes
    deterministically (utils/checkpoint.py) — preempting a multi-device
    render loses at most one chunk.
    """
    if key is None:
        key = R.base_key(cfg.seed)
    check_backend(cfg, scene)
    ndev = mesh.devices.size
    npix = cfg.num_pixels
    chunk = cfg.resolved_spp_chunk()

    if mode == "pixels":
        padded = _pad_to(npix, ndev)
        # tile-coherent lane order (render.tile_permutation): lane i renders
        # pixel perm[i]; the final image is un-permuted by scattering
        perm = tile_permutation(cfg.nx, cfg.ny)
        pixel_idx = np.zeros(padded, np.int32)
        pixel_idx[:npix] = perm
        pix_sharded = _put_sharded(pixel_idx, mesh, P("data"))

        acc = _put_sharded(np.zeros((padded, 3), np.float32), mesh,
                           P("data"))
        total_rays = 0.0
        spp_done = 0
        if checkpoint_path is not None:
            from rtw.utils import checkpoint as ckpt

            state = ckpt.load(checkpoint_path, cfg)
            if state is not None:
                acc_np, total_rays, spp_done = state
                per = np.zeros((padded, 3), np.float32)
                per[: acc_np.shape[0]] = acc_np
                acc = _put_sharded(per, mesh, P("data"))
                if verbose:
                    print(f"INFO: resumed at {spp_done}/{cfg.spp} spp",
                          file=_sys.stderr, flush=True)

        t_start = _time.perf_counter()
        s0 = spp_done
        last_ckpt = spp_done
        while s0 < cfg.spp:
            ns = min(chunk, cfg.spp - s0)
            acc, rays = _pixels_step(scene, cfg, mesh, key, pix_sharded, acc,
                                     jnp.asarray(s0, jnp.int32), ns)
            total_rays += float(rays)
            s0 += ns
            if verbose:
                jax.block_until_ready(acc)
                print(f"INFO: {s0}/{cfg.spp} spp done", file=_sys.stderr,
                      flush=True)
            if checkpoint_path is not None and (
                    s0 >= cfg.spp or checkpoint_every <= 0
                    or s0 - last_ckpt >= checkpoint_every):
                from rtw.utils import checkpoint as ckpt

                # _replicated_np is an all-gather: EVERY process must enter
                # it (only-process-0 participation deadlocks the collective
                # — found by the preempt-resume test); only process 0 then
                # touches the filesystem
                acc_np = _replicated_np(acc, mesh)[:npix]
                if jax.process_index() == 0:
                    ckpt.save(checkpoint_path, cfg, acc_np, total_rays, s0)
                last_ckpt = s0
        jax.block_until_ready(acc)
        elapsed = _time.perf_counter() - t_start
        lanes = _replicated_np(acc, mesh)[:npix]
        img = np.zeros((npix, 3), np.float32)
        img[perm] = lanes                       # un-permute tile lane order
        img /= np.float32(cfg.spp)
        if metrics is not None:
            n_paths = npix * (cfg.spp - spp_done)
            metrics.update(
                wall_seconds=elapsed, pixels=npix, spp=cfg.spp,
                devices=ndev, paths=n_paths, rays=total_rays,
                samples_per_sec=n_paths / max(elapsed, 1e-9),
                mrays_per_sec=total_rays / max(elapsed, 1e-9) / 1e6,
                **device_info(),
            )
        return img.reshape(cfg.ny, cfg.nx, 3)

    if mode == "samples":
        if cfg.spp % ndev != 0:
            raise ValueError(f"spp={cfg.spp} not divisible by {ndev} devices")
        local_spp = cfg.spp // ndev
        pixel_idx = jnp.arange(npix, dtype=jnp.int32)
        # chunk each device's sample range like the single-device render; the
        # replicated accumulator persists per chunk, so checkpoint/resume and
        # progress reporting work exactly as in pixels mode
        local_chunk = min(max(1, chunk), local_spp)

        acc = jnp.zeros((npix, 3), jnp.float32)
        total_rays = 0.0
        done = 0          # samples accumulated per device
        if checkpoint_path is not None:
            from rtw.utils import checkpoint as ckpt

            state = ckpt.load(checkpoint_path, cfg)
            if state is not None:
                acc_np, total_rays, done = state
                acc = jnp.asarray(acc_np)
                if verbose:
                    print(f"INFO: resumed at {done}/{local_spp} "
                          "spp-per-device", file=_sys.stderr, flush=True)

        t_start = _time.perf_counter()
        s0 = done
        last_ckpt = done
        while s0 < local_spp:
            ns = min(local_chunk, local_spp - s0)
            acc, rays = _samples_step(scene, cfg, mesh, key, pixel_idx, acc,
                                      jnp.asarray(s0, jnp.int32), ns,
                                      local_spp)
            total_rays += float(rays)
            s0 += ns
            if verbose:
                jax.block_until_ready(acc)
                print(f"INFO: {s0 * ndev}/{cfg.spp} spp done",
                      file=_sys.stderr, flush=True)
            if checkpoint_path is not None and (
                    s0 >= local_spp or checkpoint_every <= 0
                    or (s0 - last_ckpt) * ndev >= checkpoint_every):
                from rtw.utils import checkpoint as ckpt

                if jax.process_index() == 0:
                    ckpt.save(checkpoint_path, cfg, np.asarray(acc),
                              total_rays, s0)
                last_ckpt = s0
        acc = jax.block_until_ready(acc)
        elapsed = _time.perf_counter() - t_start
        img = np.asarray(acc) / np.float32(cfg.spp)
        if metrics is not None:
            n_paths = npix * (cfg.spp - done * ndev)
            metrics.update(
                wall_seconds=elapsed, pixels=npix, spp=cfg.spp,
                devices=ndev, paths=n_paths, rays=total_rays,
                samples_per_sec=n_paths / max(elapsed, 1e-9),
                mrays_per_sec=total_rays / max(elapsed, 1e-9) / 1e6,
                **device_info(),
            )
        return img.reshape(cfg.ny, cfg.nx, 3)

    raise ValueError(f"unknown mode {mode!r}")


def grad_sharded(scene, cfg, mesh: Mesh, params, target, key, n_samples: int):
    """Data-sharded differentiable render: pixels split across the mesh,
    per-device backward sweeps, parameter gradients psum-reduced.

    Returns (loss, grads) replicated on every device."""
    from rtw.diff import apply_params  # local import to avoid cycle

    check_backend(cfg, scene)
    ndev = mesh.devices.size
    npix = cfg.num_pixels
    # pad the pixel axis to a device multiple (same policy as render_sharded);
    # padded lanes re-trace pixel 0 with weight 0 so they contribute nothing
    # to the loss or its gradient
    padded = _pad_to(npix, ndev)
    pixel_np = np.zeros(padded, np.int32)
    pixel_np[:npix] = np.arange(npix, dtype=np.int32)
    weight_np = np.zeros((padded, 1), np.float32)
    weight_np[:npix] = 1.0
    tgt_np = np.zeros((padded, 3), np.float32)
    tgt_np[:npix] = np.asarray(target).reshape(-1, 3)
    pixel_idx = jnp.asarray(pixel_np)
    weight = jnp.asarray(weight_np)
    tgt = jnp.asarray(tgt_np)

    @jax.jit
    def run(params, pix, tgt, w):
        def local(params, pix_local, tgt_local, w_local):
            def loss_fn(p):
                sc = apply_params(scene, p)

                def body(i, acc):
                    rad, _ = trace_paths_counted(sc, cfg, pix_local, i, key)
                    return acc + rad.stack()

                acc = lax.fori_loop(
                    0, n_samples, body,
                    jnp.zeros((pix_local.shape[0], 3), jnp.float32))
                img = acc / np.float32(n_samples)
                # mean over *global* pixel count so the psum'd grad matches
                # the single-device estimator
                return (jnp.sum(w_local * (img - tgt_local) ** 2)
                        / np.float32(npix * 3))

            loss, grads = jax.value_and_grad(loss_fn)(params)
            loss = lax.psum(loss, "data")
            grads = lax.psum(grads, "data")
            return loss, grads

        return jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(), P("data"), P("data"), P("data")),
            out_specs=(P(), P()),
            check_vma=False,
        )(params, pix, tgt, w)

    return run(params, pixel_idx, tgt, weight)
