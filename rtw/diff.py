"""Differentiable rendering — a capability the reference does not have
(BASELINE.json north star: gradients w.r.t. material albedo, emission and
camera parameters, validated against finite differences).

Design: *detached sampling*.  All discrete decisions (primitive argmin,
dielectric branch choice, Russian roulette, light selection) are made by
comparisons whose gradients are zero, so reverse-mode AD through the
`lax.scan` bounce loop (cfg.differentiable=True) yields the standard
reparameterized path-gradient estimator: gradients flow through

- albedo / emission: texture table colors (attenuation + emitted radiance
  products along paths + the NEE emission term),
- camera: origin / frustum vectors -> hit points -> shading geometry
  (pixel-jitter (s, t) is reparameterized, so camera gradients are smooth),

while visibility discontinuities carry no gradient (the usual bias of
path-space differentiation without edge sampling; documented scope,
SURVEY §7.3 "gradients through a sampler").

Emission parameters appear twice in the scene (lights table for NEE,
texture color for BSDF-side hits); `Scene.light_tex` ties them so a single
parameter drives both estimator halves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from rtw.models import scene as S
from rtw.integrator import check_backend, trace_paths


def extract_params(scene: S.Scene) -> dict:
    """Differentiable parameter pytree: texture colors (albedo + emission)
    and the camera."""
    return {
        "tex_color": scene.textures.color,
        "camera": scene.camera,
    }


def apply_params(scene: S.Scene, params: dict) -> S.Scene:
    """Rebuild a scene with the given parameters installed (functionally)."""
    textures = dataclasses.replace(scene.textures, color=params["tex_color"])
    # re-derive NEE light emission from the tied texture rows
    emission = scene.lights.emission
    for i, trow in enumerate(scene.light_tex):
        if trow >= 0:
            emission = emission.at[i].set(params["tex_color"][trow])
    lights = dataclasses.replace(scene.lights, emission=emission)
    return dataclasses.replace(scene, textures=textures, lights=lights,
                               camera=params["camera"])


def render_for_grad(params: dict, scene: S.Scene, cfg, pixel_idx, key,
                    n_samples: int):
    """Differentiable estimator: mean radiance of `n_samples` samples for the
    given pixels. cfg must have differentiable=True."""
    sc = apply_params(scene, params)

    def body(i, acc):
        return acc + trace_paths(sc, cfg, pixel_idx, i, key)

    acc = lax.fori_loop(0, n_samples,
                        body, jnp.zeros((pixel_idx.shape[0], 3), jnp.float32))
    return acc / np.float32(n_samples)


def make_loss_and_grad(scene: S.Scene, cfg, n_samples: int):
    """Returns jitted (loss, grads) of mean-squared-error against a target
    image over the scene's differentiable parameters."""
    if not cfg.differentiable:
        raise ValueError("cfg.differentiable must be True for gradients")
    check_backend(cfg, scene)

    def loss_fn(params, target, pixel_idx, key):
        img = render_for_grad(params, scene, cfg, pixel_idx, key, n_samples)
        return jnp.mean((img - target) ** 2)

    return jax.jit(jax.value_and_grad(loss_fn))


def make_loss_and_grad_chunked(scene: S.Scene, cfg, n_samples: int,
                               spp_chunk: int):
    """MSE loss + gradient with **constant memory in spp** — the scaled-up
    gradient path (SURVEY §7.3 "backward-pass memory": chunk samples,
    grad-accumulate over spp batches; pairs with cfg.remat inside each
    chunk's bounce scan).

    The MSE couples samples only through the *mean image*, so:
        dL/dp = vjp(mean_img)(2 (img - target) / (N pixels * 3))
              = sum_chunks vjp(chunk_sum)(cot) / n_samples.
    Pass 1 accumulates the image with no AD residuals; pass 2 re-renders
    each chunk under jax.vjp against the fixed cotangent.  Peak memory is
    one chunk's backward, independent of n_samples (compute cost: one extra
    forward per chunk, same as any gradient-accumulation scheme).

    Returns fn(params, target, pixel_idx, key) -> (loss, grads)."""
    if not cfg.differentiable:
        raise ValueError("cfg.differentiable must be True for gradients")
    chunks = []
    s0 = 0
    while s0 < n_samples:
        chunks.append((s0, min(spp_chunk, n_samples - s0)))
        s0 += chunks[-1][1]

    import functools

    @functools.partial(jax.jit, static_argnums=(4,))
    def chunk_sum(params, pixel_idx, key, s0, ns):
        sc = apply_params(scene, params)

        def body(i, acc):
            return acc + trace_paths(sc, cfg, pixel_idx, s0 + i, key)

        return lax.fori_loop(0, ns, body,
                             jnp.zeros((pixel_idx.shape[0], 3), jnp.float32))

    @functools.partial(jax.jit, static_argnums=(5,))
    def chunk_vjp(params, pixel_idx, key, cot, s0, ns):
        _, vjp_fn = jax.vjp(
            lambda p: chunk_sum(p, pixel_idx, key, s0, ns), params)
        return vjp_fn(cot)[0]

    def run(params, target, pixel_idx, key):
        n = pixel_idx.shape[0]
        img = jnp.zeros((n, 3), jnp.float32)
        for s0, ns in chunks:
            img = img + chunk_sum(params, pixel_idx, key,
                                  jnp.asarray(s0, jnp.int32), ns)
        img = img / np.float32(n_samples)
        loss = jnp.mean((img - target) ** 2)
        cot = 2.0 * (img - target) / np.float32(n * 3 * n_samples)
        grads = None
        for s0, ns in chunks:
            g = chunk_vjp(params, pixel_idx, key, cot,
                          jnp.asarray(s0, jnp.int32), ns)
            grads = g if grads is None else jax.tree_util.tree_map(
                jnp.add, grads, g)
        return loss, grads

    return run


def finite_difference_check(scene: S.Scene, cfg, pixel_idx, key, n_samples,
                            select, eps=1e-3):
    """Central finite differences of the same estimator w.r.t. a single
    scalar selected by `select(params) -> scalar ref path`, for test use.

    `select` is (get, set): get(params)->scalar, set(params, v)->params.
    Returns (analytic, numeric).
    """
    get, put = select
    params = extract_params(scene)

    def scalar_loss(v):
        p = put(params, v)
        img = render_for_grad(p, scene, cfg, pixel_idx, key, n_samples)
        return jnp.sum(img)

    v0 = get(params)
    analytic = jax.grad(scalar_loss)(v0)
    f_plus = scalar_loss(v0 + eps)
    f_minus = scalar_loss(v0 - eps)
    numeric = (f_plus - f_minus) / (2 * eps)
    return float(analytic), float(numeric)
