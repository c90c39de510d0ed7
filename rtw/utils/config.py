"""Render configuration.

Replaces the reference's hand-rolled flag parsing + hard-coded constants
(RestOfLife/main.cpp:21-54, RestOfLife/Director.cpp:42-46) with one dataclass.
Defaults mirror the reference CLI defaults (main.cpp:34-37) except that `spp`
is a *live* parameter here: the reference parses `-ns` but traces exactly one
sample per pixel and relies on the OptiX denoiser (raygen/raygen.cu:133-147);
we restore the books' true multi-sample estimator (SURVEY §7.4 quirk 1).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (compile-time) configuration of one render.

    Everything here is hashable so a config can be a `static_argnum` to jit.
    """

    nx: int = 1200                # image width  (reference main.cpp:34)
    ny: int = 600                 # image height (reference main.cpp:35)
    spp: int = 20                 # samples per pixel (reference default Ns, main.cpp:37)
    max_depth: int = 20           # bounce limit (reference Director.cpp:42)
    seed: int = 0                 # RNG stream seed
    scene_id: int = 4             # default scene (reference main.cpp:36)

    # Estimator switches -----------------------------------------------------
    # True  -> proper MIS: BSDF-sampled rays that hit a light are weighted by
    #          powerHeuristic(bsdf_pdf, light_pdf) (unbiased).
    # False -> reference parity: BSDF-side light hits are unweighted, only the
    #          NEE side carries the power heuristic (closehit.cu:111-113 with
    #          diffuseLight.cu adding full emission) — slightly overcounts.
    mis_bsdf_weight: bool = True
    # Estimator family for diffuse lighting:
    # "mis":  NEE shadow rays + power-heuristic MIS (default; strictly
    #         lower variance).
    # "book": the books' literal 0.5/0.5 cosine/light MIXTURE — the
    #         scattered direction itself is drawn from the mixture and
    #         weighted by scattering_pdf/mixture_pdf; no shadow rays, no
    #         MIS weights (SURVEY §7.4 quirk 3 build decision; the
    #         reference's mixturePdf.cu:10-37 comments the cosine branch
    #         out, making it light-only — we implement the real mixture).
    #         Unbiased; equivalence vs "mis" is tested
    #         (tests/test_integrator.py).
    estimator: str = "mis"
    # Russian roulette start depth (raygen.cu:74 starts at depth >= 2).
    rr_start_depth: int = 2

    # Execution shape --------------------------------------------------------
    # Rays are traced in flattened batches of this many pixels; the spp loop
    # accumulates into a float32 [ny*nx, 3] buffer. 0 = whole image per batch.
    ray_batch: int = 0
    # Samples per jitted accumulation step (python loop iterates spp/spp_chunk).
    spp_chunk: int = 0            # 0 = auto

    # Trace backend --------------------------------------------------------
    # "auto": Pallas-Triton kernels on a GPU for scenes of at least
    #         integrator.KERNEL_MIN_PRIMS surface prims (ops/trace_kernel.py),
    #         pure-JAX sweep elsewhere.
    # "pallas" / "jnp": force one (pallas raises off the GPU).
    backend: str = "auto"

    # Image-texture filtering ----------------------------------------------
    # "rgb565":     bilinear from the RGB565 pair atlas — 2 flat gathers
    #               per fetch, ~1.5% color quantization.
    # "rgb8":       exact 8-bit bilinear, 4 gathers (the reference's
    #               cudaTextureObject_t semantics, ioTexture.h:293-311).
    # "nearest565": point-sampled 565, ONE gather — the speed end of the
    #               ladder for gather-bound scenes.
    # "stoch565":   stochastic bilinear from the 565 pair atlas — ONE
    #               gather: the y texel row is sampled by its bilinear
    #               weight (dedicated RNG slot), x blends exactly.
    #               E[fetch] == the "rgb565" bilinear value, so spp
    #               averaging converges to the same image (added variance
    #               is texel-difference scale, far below path noise) at
    #               nearest-mode gather cost.  ops/textures._image_stoch_565.
    #               DEFAULT; use "rgb565"/"rgb8" for a deterministic
    #               per-sample filter.
    tex_filter: str = "stoch565"

    # Tile-granular atlas gate: route per-lane image-atlas gathers through
    # 1024-lane granule compaction (only granules containing an
    # image-texture winner pay gathers; a lax.cond ladder picks a static
    # T/8 | T/4 | T/2 | T prefix width).  ops/shading._image_eval_tiled.
    tex_tile_gate: bool = True

    # Wavefront scheduler ----------------------------------------------------
    # "queue": global work-queue over (pixel, sample) items — lanes that
    #          finish a sample claim any pixel's next sample, so per-pixel
    #          difficulty variance can't strand the wavefront (the
    #          wavefront equivalent of OptiX's hardware thread scheduler).
    #          Per-pixel
    #          sums are reassociated in claim order: deterministic for a
    #          fixed batch width, not bitwise identical across widths.
    # "regen": per-lane regeneration — each lane owns one pixel; images are
    #          bitwise independent of batch width / mesh shape (use for
    #          distributed-determinism guarantees).  Slower on scenes with
    #          uneven pixel difficulty.
    # "auto":  queue on the kernel trace path, regen on the pure-XLA path
    #          (whose fully-fused bounce the queue's flush cond would
    #          split).
    scheduler: str = "auto"

    # Work-queue flush policy ----------------------------------------------
    # The queue scheduler's flush (scatter finished samples, claim new
    # items, regenerate camera rays: 3 scatter-adds + a pixel gather +
    # cumsum).  k > 0 defers it behind a lax.cond until pending lanes
    # exceed N/k (or the queue drains), so most iterations skip that work
    # entirely; pending lanes idle ~1-2 iterations.  Not yet re-measured
    # on the GPU.  0 = flush every iteration, unconditional.
    flush_denom: int = 2

    # Pixel-layout contract --------------------------------------------------
    # "tile32":  pixel_idx follows render.tile_permutation(nx, ny, 32) with
    #            lane == item position (whole image in one batch, no pad), so
    #            the work-queue flush decodes a claimed item's pixel
    #            ARITHMETICALLY (integrator.decode_tile_pixel — the lexsort's
    #            closed form) instead of gathering pixel_idx[pos].
    #            render() sets this automatically
    #            when the whole image is one batch.
    # "generic": any pixel_idx; the flush gathers.
    pixel_layout: str = "generic"

    # RNG implementation -------------------------------------------------
    # "fast": stateless pcg_hash streams keyed by (seed, pixel, sample,
    #         bounce, slot) — the GPU-rendering standard, far cheaper than
    #         threefry.
    # "threefry": jax.random counter-based streams (same logical keying).
    # "tea": the reference's generator family (tea<16> seeding + OptiX SDK
    #        LCG, lib/random.cuh) with the same logical keying — see
    #        utils/rng.py on why bit-level stream parity with the CUDA
    #        binary is out of reach.
    # All make the estimator independent of device count / mesh shape.
    rng: str = "fast"

    # Wavefront observability ------------------------------------------------
    # Collect per-bounce ray counts and wavefront occupancy counters
    # (reported via the render() metrics dict: rays_by_depth,
    # wavefront_iterations, mean_occupancy).  The per-iteration occupancy
    # TRACE (occupancy_by_iter, two [CAP] scatters per iteration) sits
    # behind occupancy_trace.
    bounce_stats: bool = False
    occupancy_trace: bool = False

    # Differentiability ------------------------------------------------------
    # When True the bounce loop uses lax.scan with a static trip count so
    # reverse-mode AD works; when False a lax.while_loop early-exits once all
    # rays in the batch are dead (faster for plain rendering).
    differentiable: bool = False
    # Rematerialize the bounce body in the backward sweep (jax.checkpoint on
    # the scan step): peak memory drops from every bounce intermediate to one
    # carried PathState per bounce, at ~1 extra forward evaluation of the
    # bounce body during the backward pass.  Only consulted when
    # differentiable=True.
    remat: bool = True

    # Misc -------------------------------------------------------------------
    gamma: float = 2.0            # output gamma (raygen.cu:150-155 uses sqrt)
    t_min: float = 1e-6           # ray epsilon (raygen.cu:46)
    t_max: float = 1e27           # effectively RT_DEFAULT_MAX
    shadow_eps: float = 5.0e-5    # occlusion ray epsilon (closehit.cu:100: 500*1e-7)

    def __post_init__(self):
        if self.nx <= 0 or self.ny <= 0:
            raise ValueError(f"bad image size {self.nx}x{self.ny}")
        if self.spp <= 0:
            raise ValueError("spp must be positive")
        if self.max_depth <= 0:
            raise ValueError("max_depth must be positive")
        if self.backend not in ("auto", "pallas", "jnp"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.scheduler not in ("auto", "queue", "regen"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}")

    @property
    def num_pixels(self) -> int:
        return self.nx * self.ny

    def resolved_ray_batch(self) -> int:
        n = self.ray_batch
        if n <= 0 or n > self.num_pixels:
            return self.num_pixels
        return n

    def resolved_spp_chunk(self, checkpointing: bool = True) -> int:
        if self.spp_chunk > 0:
            return min(self.spp_chunk, self.spp)
        # auto: every wavefront scheduler pays one drain tail per jitted
        # step whose relative cost shrinks as the chunk grows (per-pixel
        # total work concentrates ~1/sqrt(spp)); memory per step is flat
        # (per-lane accumulators).  So when nothing needs the step to be
        # interruptible the whole request is one chunk, bounded only by
        # queue item ids (cursor + rank enumerate batch*chunk items in
        # int32).  With checkpointing active a ~256M-path cap keeps steps
        # short enough that saves actually happen mid-render.
        batch = max(1, self.resolved_ray_batch())
        if checkpointing:
            per = max(1, 256_000_000 // batch)
        else:
            per = max(1, 2_000_000_000 // batch)
        return min(per, self.spp)
