"""Command-line interface.

Mirrors the reference CLI (main.cpp:44-54): `-s <scene> -ns <samples>
-dx <width> -dy <height> -v`, with the same clamp ranges (main.cpp:21-27)
— but the scene check is a plain 0..5 range (the reference's `x >= default`
check made scenes 0-3 unselectable, SURVEY §7.4 quirk 6), `-ns` actually
does something (quirk 1), and extra flags expose the new capabilities
(output path, checkpointing, sharding, estimator switches).

Run: python -m rtw.cli -s 0 -dx 600 -dy 600 -ns 1000 -o cornell.png
"""

from __future__ import annotations

import argparse
import sys
import time


def _clamp(v, lo, hi, name):
    if v < lo or v > hi:
        c = min(max(v, lo), hi)
        print(f"WARNING: {name}={v} out of [{lo},{hi}], clamped to {c}",
              file=sys.stderr)
        return c
    return v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rtw",
        description="differentiable wavefront path tracer in JAX "
                    "(Ray Tracing in One Weekend series)")
    p.add_argument("-s", "--scene", type=int, default=4,
                   help="scene id 0-5 (default 4, TNW final)")
    p.add_argument("-ns", "--samples", type=int, default=20,
                   help="samples per pixel (default 20)")
    p.add_argument("-dx", "--width", type=int, default=1200)
    p.add_argument("-dy", "--height", type=int, default=600)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-g", "--debug", action="store_true",
                   help="debug mode: enable jax NaN checking")
    p.add_argument("-o", "--output", default="-",
                   help="output path (.png/.ppm) or '-' for PPM on stdout")
    p.add_argument("--max-depth", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dof", choices=["reference", "book"], default="reference",
                   help="depth of field: 'reference' = off (parity with the "
                        "reference, which never wires the lens radius), "
                        "'book' = literal scene apertures")
    p.add_argument("--estimator", choices=["mis", "reference", "book"],
                   default="mis",
                   help="'mis': NEE + MIS-weighted BSDF light hits "
                        "(unbiased, lowest variance); 'reference': NEE with "
                        "unweighted BSDF light hits, parity with the CUDA "
                        "ref; 'book': the books' literal 0.5/0.5 "
                        "cosine/light mixture (no shadow rays)")
    p.add_argument("--checkpoint", default=None,
                   help="accumulator checkpoint path (resume if it exists)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint every N samples (0: every spp chunk)")
    p.add_argument("--sharded", action="store_true",
                   help="shard pixels over all visible devices")
    p.add_argument("--denoise", action="store_true",
                   help="edge-avoiding a-trous post-filter guided by a "
                        "first-hit G-buffer (classical analog of the "
                        "reference's OptiX LDR denoiser; non-parity)")
    p.add_argument("--metrics-json", default=None,
                   help="write render metrics JSON next to the image")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace of the render into "
                        "this directory (view with TensorBoard/Perfetto)")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--scheduler", choices=["auto", "queue", "regen"],
                   default="auto",
                   help="wavefront scheduler: global work-queue (fast on "
                        "uneven scenes) or per-lane regeneration (bitwise "
                        "batch/mesh-shape-invariant); auto picks per scene")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from rtw.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.debug:
        import jax

        jax.config.update("jax_debug_nans", True)

    # reference clamp ranges (main.cpp:21-27)
    nx = _clamp(args.width, 320, 3840, "dx")
    ny = _clamp(args.height, 200, 2240, "dy")
    ns = _clamp(args.samples, 1, 10240, "ns")
    if not 0 <= args.scene <= 5:
        print(f"ERROR: Scene {args.scene} unknown.", file=sys.stderr)
        return 1

    from rtw import RenderConfig, build_scene
    from rtw.render import render, to_srgb8
    from rtw.models.registry import SCENE_NAMES
    from rtw.utils.image import write_image

    cfg = RenderConfig(nx=nx, ny=ny, spp=ns, max_depth=args.max_depth,
                       seed=args.seed, scene_id=args.scene,
                       scheduler=args.scheduler,
                       estimator=("book" if args.estimator == "book"
                                  else "mis"),
                       mis_bsdf_weight=(args.estimator != "reference"),
                       # metrics sidecar requested -> collect the per-bounce
                       # wavefront counters too (single-device render path)
                       bounce_stats=bool(args.metrics_json
                                         and not args.sharded))
    if args.verbose:
        print(f"INFO: {nx}x{ny}, {ns} spp, scene {args.scene}: "
              f"{SCENE_NAMES[args.scene]}", file=sys.stderr)

    import contextlib

    from rtw.utils.profiling import Phases, trace, write_metrics

    phases = Phases()
    prof = trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    t0 = time.time()
    with phases("scene_build"):
        scene = build_scene(args.scene, nx, ny, dof=args.dof)
    metrics: dict = {}
    with prof, phases("render"):
        if args.sharded:
            from rtw.parallel.mesh import make_mesh, render_sharded

            img = render_sharded(scene, cfg, make_mesh(), metrics=metrics,
                                 verbose=args.verbose,
                                 checkpoint_path=args.checkpoint,
                                 checkpoint_every=args.checkpoint_every)
        else:
            img = render(scene, cfg, verbose=args.verbose, metrics=metrics,
                         checkpoint_path=args.checkpoint,
                         checkpoint_every=args.checkpoint_every)
    elapsed = time.time() - t0
    if args.verbose:
        print(f"INFO: Took {elapsed:.1f} seconds", file=sys.stderr)

    if args.denoise:
        from rtw.denoise import denoise

        disp = denoise(img, scene, cfg, gamma=cfg.gamma)  # display-space
        out8 = to_srgb8(disp, gamma=1.0)
    else:
        out8 = to_srgb8(img, cfg.gamma)
    write_image(out8, args.output)
    if args.metrics_json:
        write_metrics(args.metrics_json, metrics, phases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
