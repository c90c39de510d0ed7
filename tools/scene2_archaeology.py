"""Scene-2 parity archaeology (VERDICT r3 item 7).

PARITY.md explains scene 2's SSIM-0.445 outlier by claiming the committed
reference PNG (TNW-Optix-lighting-IOW-final.png) was rendered from the
ALTERNATIVE overhead y=10 sky-light variant that is commented out in the
reference source (ioScene.h:363-364) rather than the live z=-2 rect
(ioScene.h:351).  This tool turns that inference into evidence: it renders
BOTH variants at the parity workload and commits a 3-way strip
(live-code render | reference PNG | y=10 variant render) with SSIMs.

If the story is right, SSIM(variant, ref) >> SSIM(live, ref).

Run:  python tools/scene2_archaeology.py [--spp 200] [--width 400]
Writes docs/parity/scene2_archaeology.png and prints one JSON line.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF = ("/root/reference/RestOfLife/assets/img/"
       "TNW-Optix-lighting-IOW-final.png")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=200)
    ap.add_argument("--denoise", action="store_true",
                    help="score denoise(render) against the reference PNG "
                         "(which IS denoiser output) — the round-5 control "
                         "that bounds how much of the live-vs-reference "
                         "residual the phantom-NEE reproduction explains "
                         "once the noise regime is removed from both sides")
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from PIL import Image
    import rtw as rt
    from rtw.models import registry
    from rtw.utils.image import ssim

    ref = Image.open(REF).convert("RGB")
    rw, rh = ref.size
    nx = args.width
    ny = max(8, round(nx * rh / rw))
    ref_small = np.asarray(ref.resize((nx, ny), Image.LANCZOS),
                           np.float32) / 255.0

    cfg = rt.RenderConfig(nx=nx, ny=ny, spp=args.spp, max_depth=20,
                          scene_id=2)

    def shoot(scene):
        if args.denoise:
            from rtw.denoise import denoise

            linear = rt.render(scene, cfg)
            disp = np.asarray(denoise(linear, scene, cfg, mode="ldr",
                                      gamma=cfg.gamma))
            return np.clip(disp, 0.0, 1.0)[::-1]
        img8 = rt.render_image(scene, cfg)
        return np.asarray(img8, np.float32) / 255.0

    renders = {}
    for variant in ["live", "sky_y10"]:
        scene = registry.in_one_weekend_light(nx / ny,
                                              light_variant=variant)
        renders[variant] = shoot(scene)

    # Third hypothesis — the reference's own NEE divergence (QUIRKS #16):
    # its PDF tree samples the PHANTOM rect {3,5, 2.3,6, z=-2}
    # (ioScene.h:125) instead of the actual light rect {3,5, 1,3} and
    # credits full emission for sample points off the light (rect pdf
    # "value" callables are stubbed, mixture is light-only).  Reproduce by
    # pointing OUR NEE light row at the phantom rect (pure pytree surgery —
    # the builder would rightly reject this as a partial-overlap light):
    import dataclasses
    import jax.numpy as jnp
    from rtw.models.scene import Lights
    scene = registry.in_one_weekend_light(nx / ny)
    phantom = Lights(
        position=jnp.asarray([[3.0, 2.3, -2.0]], jnp.float32),
        vec_u=jnp.asarray([[2.0, 0.0, 0.0]], jnp.float32),
        vec_v=jnp.asarray([[0.0, 3.7, 0.0]], jnp.float32),
        emission=jnp.asarray([[16.0, 16.0, 16.0]], jnp.float32),
        area=jnp.asarray([2.0 * 3.7], jnp.float32),
        normal=jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32))
    scene = dataclasses.replace(scene, lights=phantom)
    renders["phantom_nee"] = shoot(scene)

    if args.out is None:
        args.out = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "docs", "parity",
            "scene2_archaeology%s.png" % ("_denoised" if args.denoise
                                          else ""))
    scores = {k: ssim(v, ref_small) for k, v in renders.items()}
    strip = np.concatenate([renders["live"], ref_small,
                            renders["sky_y10"], renders["phantom_nee"]],
                           axis=1)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    Image.fromarray((strip * 255).astype(np.uint8)).save(args.out)
    best = max(scores, key=scores.get)
    print(json.dumps({
        "ssim_live_vs_ref": round(scores["live"], 4),
        "ssim_y10_variant_vs_ref": round(scores["sky_y10"], 4),
        "ssim_phantom_nee_vs_ref": round(scores["phantom_nee"], 4),
        "strip": args.out, "denoised": bool(args.denoise),
        "strip_order": "live | reference | y10-variant | phantom-NEE",
        "best_match": best,
    }), flush=True)


if __name__ == "__main__":
    main()
