"""Scaled inverse-render demonstration (SURVEY §7.3 backward-pass memory).

Renders a target image of the differentiable demo scene, perturbs the ball
albedo, and recovers it by gradient descent at >= 200x200 px using the
constant-memory spp-chunked gradient (diff.make_loss_and_grad_chunked) with
cfg.remat bounce rematerialization.  Reports per-step loss and peak device
memory.

Usage: python tools/grad_demo.py [--size 200] [--spp 8] [--chunk 2]
                                 [--steps 12]
Writes results JSON to stdout (one line) for docs/GRADIENTS.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def demo_scene(aspect: float):
    from rtw.models.builder import SceneBuilder
    import rtw.models.scene as S

    b = SceneBuilder()
    ground = b.lambertian(b.constant_texture((0.6, 0.5, 0.4)))
    ball = b.lambertian(b.constant_texture((0.3, 0.6, 0.2)))
    lt = b.constant_texture((5.0, 5.0, 5.0))
    b.sphere((0.0, -100.5, -3.0), 100.0, ground)
    b.sphere((0.0, 0.0, -3.0), 0.5, ball)
    b.rect(-1.0, 1.0, -1.0, 1.0, 3.0, True, S.AXIS_Y, b.diffuse_light(lt))
    b.add_light((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0),
                (5.0, 5.0, 5.0), tex=lt)
    b.set_camera((0, 0.3, 0), (0, 0, -3), (0, 1, 0), 45, aspect, 0.0, 1.0)
    return b.build(), 1  # ball texture row


def peak_hbm_mb() -> float:
    import jax

    try:
        stats = jax.local_devices()[0].memory_stats()
        return float(stats.get("peak_bytes_in_use", 0)) / 1e6
    except Exception:
        return -1.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=200)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=2)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--lr", type=float, default=0.6)
    ap.add_argument("--no-remat", action="store_true",
                    help="disable jax.checkpoint on the bounce scan "
                         "(peak-memory comparison for docs/GRADIENTS.md)")
    ap.add_argument("--mem-analysis", action="store_true",
                    help="also compile remat/chunk variants and report "
                         "XLA's planned temp-buffer sizes")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import rtw as rt
    from rtw.diff import (extract_params, make_loss_and_grad_chunked,
                              render_for_grad)
    from rtw.utils import rng as R

    n = args.size
    cfg = rt.RenderConfig(nx=n, ny=n, spp=args.spp, max_depth=8,
                          differentiable=True, remat=not args.no_remat)
    scene, ball_row = demo_scene(1.0)
    key = R.base_key(11)
    pix = jnp.arange(cfg.num_pixels, dtype=jnp.int32)

    true_params = extract_params(scene)
    target = jax.jit(lambda p: render_for_grad(
        p, scene, cfg, pix, key, args.spp))(true_params)
    target = jax.block_until_ready(target)

    # perturb the ball albedo and descend
    params = jax.tree_util.tree_map(lambda x: x, true_params)
    params["tex_color"] = params["tex_color"].at[ball_row].set(
        jnp.asarray([0.85, 0.15, 0.75]))

    loss_grad = make_loss_and_grad_chunked(scene, cfg, args.spp, args.chunk)
    t0 = time.perf_counter()
    losses = []
    for step in range(args.steps):
        loss, grads = loss_grad(params, target, pix, key)
        # normalized descent on the BALL's albedo row only (matching the
        # perturbation; a whole-table update would clip the light's 5.0
        # emission row to 1 and darken the scene).  Normalized because the
        # absolute gradient scale grows with pixel count — the demo's claim
        # is that the gradient DIRECTION recovers the albedo.
        gball = grads["tex_color"][ball_row]
        lr = args.lr * (0.88 ** max(0, step - 8))   # decay once near optimum
        step_v = lr * gball / (jnp.max(jnp.abs(gball)) + 1e-20)
        params["tex_color"] = params["tex_color"].at[ball_row].set(
            jnp.clip(params["tex_color"][ball_row] - step_v, 0.0, 1.0))
        losses.append(float(loss))
        print(f"step {step}: loss {float(loss):.3e}", file=sys.stderr,
              flush=True)
    wall = time.perf_counter() - t0

    mem = {}
    if args.mem_analysis:
        # XLA's compile-time buffer plan: temp_size is the backward-pass
        # residual footprint that remat + spp-chunking exist to bound
        # (SURVEY §7.3)
        import dataclasses
        from rtw.diff import make_loss_and_grad

        def planned_mb(remat: bool, ns: int) -> float:
            cfg_v = dataclasses.replace(cfg, remat=remat, spp=ns)
            fn = make_loss_and_grad(scene, cfg_v, ns)
            tgt = jnp.zeros((cfg.num_pixels, 3), jnp.float32)
            c = fn.lower(true_params, tgt, pix, key).compile()
            return round(c.memory_analysis().temp_size_in_bytes / 1e6, 1)

        mem = {
            "planned_temp_mb_full_noremat": planned_mb(False, args.spp),
            "planned_temp_mb_full_remat": planned_mb(True, args.spp),
            "planned_temp_mb_chunk_remat": planned_mb(True, args.chunk),
        }

    got = np.asarray(params["tex_color"][ball_row])
    want = np.asarray(true_params["tex_color"][ball_row])
    print(json.dumps({
        **mem,
        "size": n, "spp": args.spp, "spp_chunk": args.chunk,
        "remat": not args.no_remat,
        "steps": args.steps,
        "loss_first": round(losses[0], 6), "loss_last": round(losses[-1], 6),
        "ball_albedo_recovered": [round(float(x), 4) for x in got],
        "ball_albedo_true": [round(float(x), 4) for x in want],
        "max_abs_err": round(float(np.abs(got - want).max()), 4),
        "wall_seconds": round(wall, 1),
        "peak_hbm_mb": round(peak_hbm_mb(), 1),
    }))


if __name__ == "__main__":
    main()
