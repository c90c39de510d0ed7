"""Reference-image comparison harness (SURVEY roadmap: structural goldens).

Renders each scene at the aspect of the reference's committed render
(RestOfLife/assets/img/*) and reports SSIM + mean-abs-error against the
reference image downscaled to the same size.  These are *qualitative*
structural goldens: the reference traces 1 spp through the closed OptiX NN
denoiser with a different RNG, a disabled lens radius, and the quirk ledger
of SURVEY §7.4, so per-pixel equality is not defined — SSIM >> 0.5 with the
right layout/colors is the meaningful check.

Run (renders on whatever backend jax picks):
    python tools/compare_reference.py [-s SID ...] [--width 400] [--spp 200]
Writes side-by-side PNGs to --out-dir and prints one JSON line per scene.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_DIR = "/root/reference/RestOfLife/assets/img"

# scene id -> (reference render, note)
REFERENCE_IMAGES = {
    0: ("rol-optix-final-alum_10k.png",
        "Rest-of-Life final (Cornell + aluminum box + glass sphere), 10k spp"),
    1: ("IOW-OptiX-final.png", "IOW final with moving spheres"),
    2: ("TNW-Optix-lighting-IOW-final.png", "IOW + rect light scene"),
    4: ("TNW-Optix-final.png", "The Next Week final"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-s", "--scenes", type=int, nargs="*",
                    default=sorted(REFERENCE_IMAGES))
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--spp", type=int, default=200)
    ap.add_argument("--max-depth", type=int, default=20)
    ap.add_argument("--out-dir", default="/tmp/parity")
    ap.add_argument("--denoise", action="store_true",
                    help="score denoise(ours) against the reference — the "
                         "like-for-like comparison (the reference PNGs ARE "
                         "denoiser output, Director.cpp:887-949); decouples "
                         "estimator divergence from the noise-vs-denoiser "
                         "regime in the plain scores")
    args = ap.parse_args(argv)

    from PIL import Image

    import rtw as rt
    from rtw.utils.image import ssim

    os.makedirs(args.out_dir, exist_ok=True)
    for sid in args.scenes:
        fname, note = REFERENCE_IMAGES[sid]
        ref = Image.open(os.path.join(REF_DIR, fname)).convert("RGB")
        rw, rh = ref.size
        nx = args.width
        ny = max(8, round(nx * rh / rw))
        ref_small = np.asarray(ref.resize((nx, ny), Image.LANCZOS),
                               np.float32) / 255.0

        cfg = rt.RenderConfig(nx=nx, ny=ny, spp=args.spp,
                              max_depth=args.max_depth, scene_id=sid)
        scene = rt.build_scene(sid, nx, ny)
        if args.denoise:
            from rtw.denoise import denoise

            linear = rt.render(scene, cfg)           # bottom-origin linear
            disp = np.asarray(denoise(linear, scene, cfg, mode="ldr",
                                      gamma=cfg.gamma))
            ours = np.clip(disp, 0.0, 1.0)[::-1]     # top-row-first display
            tag = "_denoised"
        else:
            img8 = rt.render_image(scene, cfg)       # display space uint8
            ours = np.asarray(img8, np.float32) / 255.0
            tag = ""

        s = ssim(ours, ref_small)
        mae = float(np.abs(ours - ref_small).mean())
        side = np.concatenate([ours, ref_small], axis=1)
        Image.fromarray((side * 255).astype(np.uint8)).save(
            os.path.join(args.out_dir, f"scene{sid}_vs_ref{tag}.png"))
        print(json.dumps({"scene": sid, "reference": fname,
                          "denoised": bool(args.denoise),
                          "ssim": round(s, 4),
                          "mae": round(mae, 4), "note": note}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
