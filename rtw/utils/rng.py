"""Random-number discipline.

Device side: counter-based threefry (`jax.random`) keyed by logical
(pixel, sample, bounce) indices.  This replaces the reference's stateful
`tea<64>`-seeded LCG stream (RestOfLife/lib/random.cuh, raygen.cu:129) and is
what makes the estimator independent of device count / mesh shape: a pixel's
sample draws the same uniforms no matter which chip traces it.

Host side: an exact reimplementation of the reference's xorshift32 `randf`
(lib/random.cuh:22-38) — the random scenes (MovingSpheres seed 0x314759,
InOneWeekendLight seed 0x6314759, TheNextWeekFinal seed 0x6314759) are built
with the literal bit-exact sequence so scene geometry matches the reference
exactly (SURVEY §7.3 "RNG parity").
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# Per-bounce uniform slot layout (columns of the [N, NU] draw block).
# One block of uniforms is drawn per ray per bounce; every consumer reads a
# fixed column, which keeps the consumption order data-independent (unlike the
# reference's call-site-ordered LCG stream).
U_SCATTER_0 = 0        # material scatter draw 1 (cosine phi / sphere z / ...)
U_SCATTER_1 = 1        # material scatter draw 2
U_SCATTER_2 = 2        # material scatter draw 3 (unit-sphere radius shaping)
U_DIELECTRIC = 3       # reflect-vs-refract proposal
U_LIGHT_SELECT = 4     # uniform light index
U_LIGHT_A = 5          # point-on-light u
U_LIGHT_B = 6          # point-on-light v
U_RR = 7               # russian roulette
NUM_FIXED_SLOTS = 8
# Columns [NUM_FIXED_SLOTS, NUM_FIXED_SLOTS + n_vol) hold the free-flight
# draws for volume primitive slot v on the main ray; the following n_vol
# columns hold the same for the NEE occlusion ray.


def base_key(seed: int) -> jax.Array:
    return jax.random.key(seed)


# ---------------------------------------------------------------------------
# Fast counter-based hash RNG (default, cfg.rng="fast")
#
# pcg_hash from Jarzynski & Olano, "Hash Functions for GPU Rendering" (JCGT
# 2020) — the de-facto standard stateless generator for GPU Monte-Carlo
# rendering.  ~6 integer ops per draw vs ~10^2-10^3 for threefry; statistical
# quality far above the reference's tea<64>-seeded LCG (lib/random.cuh).
# Every draw is a pure function of (seed, pixel, sample, bounce, slot), so
# the estimator is independent of device count, mesh shape and wavefront
# packing — the same property the threefry path has.
# ---------------------------------------------------------------------------

_GOLDEN = np.uint32(0x9E3779B9)   # 2^32 / phi: distinct-stream offset


def pcg_hash(x):
    x = x.astype(jnp.uint32)
    state = x * np.uint32(747796405) + np.uint32(2891336453)
    word = ((state >> ((state >> np.uint32(28)) + np.uint32(4))) ^ state) \
        * np.uint32(277803737)
    return (word >> np.uint32(22)) ^ word


def _to_unit(bits):
    """uint32 -> float32 in [0, 1) using the top 24 bits."""
    return (bits >> np.uint32(8)).astype(jnp.float32) * np.float32(1.0 / (1 << 24))


def pixel_sample_hash(key: jax.Array, pixel_idx: jax.Array, sample_idx) -> jax.Array:
    """Per-path hash state (uint32 [N]) for the fast RNG.

    Chained pcg_hash over (key material, sample, pixel): each stage fully
    mixes before the next logical index is added, the standard construction
    for multi-dimensional GPU hashes."""
    kd = jax.random.key_data(key).astype(jnp.uint32).reshape(-1)
    h0 = pcg_hash(kd[0] + pcg_hash(kd[-1]))
    h1 = pcg_hash(h0 + jnp.asarray(sample_idx).astype(jnp.uint32))
    return pcg_hash(h1 + pixel_idx.astype(jnp.uint32))


# ---------------------------------------------------------------------------
# Parity-family RNG (cfg.rng="tea"): the reference's generator pair —
# tea<16> seeding + the OptiX SDK LCG (lib/random.cuh via cuda/random.h;
# raygen.cu:129 seeds with tea(pixel_index, 0)).  Draws here are keyed by
# (pixel, sample, bounce) like the other backends: per-path tea state, a
# tea-mixed per-bounce substream, then *sequential* LCG draws per slot —
# the same generators consumed in a fixed slot order.  Bit-level parity with
# the CUDA binary's call-site-ordered stream is not reproducible (or
# verifiable) off NVIDIA hardware; this mode exists to render with the
# reference's generator family (e.g. for RNG-sensitivity comparisons).
# ---------------------------------------------------------------------------

def tea(v0, v1, rounds: int = 16):
    """Tiny Encryption Algorithm hash of two uint32 words (OptiX SDK tea<N>)."""
    v0 = jnp.asarray(v0).astype(jnp.uint32)
    v1 = jnp.broadcast_to(jnp.asarray(v1).astype(jnp.uint32), jnp.shape(v0))
    s = 0
    for _ in range(rounds):
        s = (s + 0x9E3779B9) & 0xFFFFFFFF
        v0 = v0 + (((v1 << np.uint32(4)) + np.uint32(0xA341316C))
                   ^ (v1 + np.uint32(s))
                   ^ ((v1 >> np.uint32(5)) + np.uint32(0xC8013EA4)))
        v1 = v1 + (((v0 << np.uint32(4)) + np.uint32(0xAD90777D))
                   ^ (v0 + np.uint32(s))
                   ^ ((v0 >> np.uint32(5)) + np.uint32(0x7E95761E)))
    return v0


def _lcg_draws(state, k: int):
    """k sequential LCG draws (seed = 1664525*seed + 1013904223; value =
    low 24 bits / 2^24 — cuda/random.h rnd()).  Returns ([k, N], new state)."""
    rows = []
    for _ in range(k):
        state = state * np.uint32(1664525) + np.uint32(1013904223)
        rows.append((state & np.uint32(0x00FFFFFF)).astype(jnp.float32)
                    * np.float32(1.0 / 16777216.0))
    return jnp.stack(rows, axis=0), state


def _tea_path_state(key, pixel_idx, sample_idx):
    kd = jax.random.key_data(key).astype(jnp.uint32).reshape(-1)
    s = jnp.asarray(sample_idx).astype(jnp.uint32) + kd[0]
    return tea(pixel_idx.astype(jnp.uint32), s)


def _is_threefry(path_keys) -> bool:
    return jnp.issubdtype(path_keys.dtype, jax.dtypes.prng_key)


def pixel_sample_keys(key: jax.Array, pixel_idx: jax.Array, sample_idx) -> jax.Array:
    """Threefry key for each (pixel, sample) path. pixel_idx: int32 [N];
    sample_idx: scalar or per-lane [N] (the regenerating wavefront advances
    each lane's sample cursor independently)."""
    if jnp.ndim(jnp.asarray(sample_idx)) == 0:
        k = jax.random.fold_in(key, sample_idx)
        return jax.vmap(lambda p: jax.random.fold_in(k, p))(pixel_idx)
    s = jnp.broadcast_to(jnp.asarray(sample_idx), pixel_idx.shape)
    return jax.vmap(
        lambda p, ss: jax.random.fold_in(jax.random.fold_in(key, ss), p)
    )(pixel_idx, s)


def make_path_keys(key, pixel_idx, sample_idx, impl: str = "fast"):
    """Per-path RNG state: uint32 hash plane ("fast"/"tea") or threefry keys."""
    if impl == "fast":
        return pixel_sample_hash(key, pixel_idx, sample_idx)
    if impl == "tea":
        return _tea_path_state(key, pixel_idx, sample_idx)
    if impl == "threefry":
        return pixel_sample_keys(key, pixel_idx, sample_idx)
    raise ValueError(f"unknown rng impl {impl!r}")


def bounce_uniforms(path_keys: jax.Array, bounce, n_slots: int,
                    impl: str = "fast") -> jax.Array:
    """Draw the per-bounce uniform block: [n_slots, N] in [0, 1).

    Slot-major so each slot row is a dense [N] plane (rays on the vector
    lanes; see ops/vec.py on layout).  `bounce` may be a scalar or a
    per-lane [N] vector (persistent-wavefront paths at different depths).
    """
    if impl == "tea" and not _is_threefry(path_keys):
        sub = tea(path_keys, jnp.asarray(bounce).astype(jnp.uint32) + 1,
                  rounds=8)
        rows, _ = _lcg_draws(sub, n_slots)
        return rows
    if _is_threefry(path_keys):
        b = jnp.broadcast_to(jnp.asarray(bounce), path_keys.shape)

        def draw(k, bb):
            return jax.random.uniform(jax.random.fold_in(k, bb), (n_slots,),
                                      jnp.float32)
        return jax.vmap(draw, out_axes=1)(path_keys, b)

    hb = pcg_hash(path_keys + jnp.asarray(bounce).astype(jnp.uint32) * _GOLDEN)
    # double hash: slot streams are offsets of one well-mixed state, and the
    # second pcg application breaks the residual linear relation between them
    rows = [_to_unit(pcg_hash(pcg_hash(hb + np.uint32(k + 1))))
            for k in range(n_slots)]
    return jnp.stack(rows, axis=0)


def camera_uniforms(path_keys: jax.Array, impl: str = "fast") -> jax.Array:
    """Draws consumed before the bounce loop: jitter s,t; lens u1,u2; time.
    Returns [5, N]."""
    if impl == "tea" and not _is_threefry(path_keys):
        rows, _ = _lcg_draws(path_keys, 5)   # reference order: jitter first
        return rows
    if _is_threefry(path_keys):
        def draw(k):
            return jax.random.uniform(jax.random.fold_in(k, 0x0CA4), (5,),
                                      jnp.float32)
        return jax.vmap(draw, out_axes=1)(path_keys)

    # camera-draw stream offset (0x0CA4 * golden, wrapped mod 2^32)
    hc = pcg_hash(path_keys + np.uint32((0x0CA4 * 0x9E3779B9) & 0xFFFFFFFF))
    rows = [_to_unit(pcg_hash(pcg_hash(hc + np.uint32(k + 1))))
            for k in range(5)]
    return jnp.stack(rows, axis=0)


# ---------------------------------------------------------------------------
# Host scene-construction RNG (bit-exact vs reference lib/random.cuh)
# ---------------------------------------------------------------------------

class XorShift32:
    """Reference host RNG: xorshift32 + float mapping of lib/random.cuh:22-38."""

    def __init__(self, seed: int):
        if seed == 0:
            raise ValueError("xorshift32 state must be nonzero")
        self.state = np.uint32(seed)

    def next_u32(self) -> int:
        s = int(self.state)
        s ^= (s << 13) & 0xFFFFFFFF
        s ^= s >> 17
        s ^= (s << 5) & 0xFFFFFFFF
        self.state = np.uint32(s)
        return s

    def randf(self) -> float:
        # float(u32) / 2^32, with the reference's curious guard that a result
        # of exactly 1.0 returns the bit pattern 0x3F7FFFFF *as an int
        # converted to float* (random.cuh:34-37). float32(u32)/2^32 can round
        # to 1.0 for u32 > 0xFFFFFF80; reproduce the guard faithfully.
        u = self.next_u32()
        rnd = np.float32(np.float32(u) / np.float32(4294967296.0))
        if rnd != np.float32(1.0):
            return float(rnd)
        return float(0x3F7FFFFF)  # literal int-to-float conversion quirk
