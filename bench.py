"""Benchmark harness — prints ONE JSON line:
{"metric": ..., "value": N, "unit": ..., "device": {...}, "nvidia_smi": ...}

Headline metric: Mrays/s per card on the Cornell box at 800x800, 1000 spp,
depth 20.  Rays counted = every traversal query actually issued (camera +
bounce + NEE shadow rays), the same accounting OptiX applications use.
Wall time excludes compilation (the warm-up run is a full render with the
IDENTICAL config, so every per-chunk step graph is compiled before timing)
and includes device sync.

Exits nonzero when JAX finds no GPU, unless --cpu is given.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BENCH_NX = 800
BENCH_NY = 800
BENCH_SPP = 1000
BENCH_DEPTH = 20


def main(argv):
    from tools.bench_scenes import nvidia_smi, require_device

    device = require_device("--cpu" in argv)
    from rtw import RenderConfig, build_scene, render

    cfg = RenderConfig(nx=BENCH_NX, ny=BENCH_NY, spp=BENCH_SPP,
                       max_depth=BENCH_DEPTH, scene_id=0)
    scene = build_scene(0, cfg.nx, cfg.ny)

    # warm-up: one full render with the IDENTICAL config (the config is a
    # static jit argument, so any variation would recompile)
    render(scene, cfg)

    metrics = {}
    img = render(scene, cfg, metrics=metrics)
    assert np.isfinite(np.asarray(img)).all()

    print(json.dumps({
        "metric": "cornell_800x800_1000spp_mrays_per_sec_per_card",
        "value": metrics["mrays_per_sec"],
        "unit": "Mrays/s",
        "device": device,
        "nvidia_smi": nvidia_smi(),
    }))
    print(json.dumps({"detail": metrics}), file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
