"""Scale probe: Mrays/s vs primitive count on the GPU.

Builds synthetic N-sphere scenes (uniform in a 400-unit cube) far beyond
the largest reference scene (TNW ~1.4k prims) and measures one-card
throughput of the brute-force sweep, whose cost is linear in the
primitive count — the motivation for a BVH (ROADMAP B1).  Reference
capability: optixAccelBuild's log-N BVH traversal at any primitive count
(ioGeometryGroup.h:160-225).

Usage:
  python tools/stress_scale.py [--cpu] [--counts 4096 16384]
Writes one JSON line per config to stdout.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def build_stress_scene(n_spheres: int):
    from rtw.models.builder import SceneBuilder

    b = SceneBuilder()
    rng = np.random.default_rng(5)
    mat = b.lambertian(b.constant_texture((0.5, 0.5, 0.5)))
    centers = rng.uniform(-200, 200, (n_spheres, 3))
    radii = rng.uniform(1.0, 5.0, n_spheres)
    for c, r in zip(centers, radii):
        b.sphere(c, float(r), mat)
    b.set_camera(lookfrom=(0, 0, -500), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov=40.0, aspect=1.0, aperture=0.0, focus_dist=10.0)
    return b.build()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--counts", type=int, nargs="*",
                    default=[4096, 16384, 65536])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=4)
    args = ap.parse_args()

    from tools.bench_scenes import require_device

    require_device(args.cpu)
    from rtw import RenderConfig, render

    for n in args.counts:
        t0 = time.time()
        scene = build_stress_scene(n)
        build_s = time.time() - t0
        cfg = RenderConfig(nx=args.size, ny=args.size, spp=args.spp,
                           max_depth=8, scene_id=0)
        render(scene, cfg)               # warm-up / compile
        best = None
        for _ in range(3):
            m = {}
            render(scene, cfg, metrics=m)
            best = m if best is None or m["mrays_per_sec"] > best[
                "mrays_per_sec"] else best
        print(json.dumps({
            "n_prims": n,
            "mrays_per_sec": best["mrays_per_sec"],
            "wall_seconds": best["wall_seconds"],
            "build_seconds": build_s,
            "device": best["device_kind"],
        }), flush=True)


if __name__ == "__main__":
    main()
