"""rtw — a differentiable wavefront path tracer in JAX.

A from-scratch JAX / XLA / Pallas re-design of the capabilities of the
OptiX/CUDA reference `safes/RayTracing-Weekend` (Peter Shirley's *Ray Tracing
in One Weekend* series through *The Rest of Your Life*), built
wavefront-style for data-parallel accelerators (runs on NVIDIA GPUs):

- SoA ray state in device memory, lockstep bounce loop (`lax.while_loop` / `lax.scan`)
  with alive-masking instead of OptiX's megakernel + SER reordering
  (reference: RestOfLife/raygen/raygen.cu:28-87).
- Vectorized brute-force primitive sweep (XLA, or a Pallas-Triton kernel
  with per-ray-block AABB block culling on the GPU) instead of hardware BVH
  `optixTraverse` (reference: RestOfLife/geometry/*.cu); a BVH is on the
  roadmap.
- Branch-free masked material shading instead of direct-callable function
  tables (reference: RestOfLife/shaders/closehit.cu, material/*.cu).
- Counter-based threefry RNG keyed by (pixel, sample, bounce) so images are
  independent of device mesh shape (reference: tea<64> + LCG, lib/random.cuh).
- Differentiable forward render (gradients w.r.t. albedo / emission / camera)
  and multi-host sharding via `jax.sharding.Mesh` + `shard_map` — both new
  capabilities absent from the single-GPU reference.

Package layout:
  models/    scene/world model: cameras, materials, textures, lights, scenes 0-4
  ops/       compute kernels: intersection sweeps, Pallas-Triton trace kernels,
             shading, sampling, textures
  parallel/  device mesh, sharded rendering, distributed bootstrap
  utils/     config, RNG, image I/O, metrics, logging
"""

from rtw.utils.config import RenderConfig
from rtw.render import render, render_image
from rtw.models.registry import build_scene, SCENE_NAMES

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "render",
    "render_image",
    "build_scene",
    "SCENE_NAMES",
]
