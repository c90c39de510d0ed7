"""Record the wavefront occupancy story on the GPU.

Runs the big scenes with cfg.bounce_stats under both schedulers and writes
chiprun_out/occupancy.json: per-scene wavefront iterations, mean
occupancy, rays-by-depth histogram and the occupancy-by-iteration curve —
the evidence behind the work-queue scheduler's occupancy claims
(integrator.trace_wavefront_queue docstring).

Usage: python tools/occupancy_report.py [--cpu] [scene_id ...]
(default: 1 2 4)
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

WORKLOADS = {1: (800, 400, 16), 2: (800, 400, 16), 4: (800, 400, 8)}
OUT = os.path.join(os.path.dirname(__file__), "..", "chiprun_out",
                   "occupancy.json")


def main(argv):
    from tools.bench_scenes import require_device

    device = require_device("--cpu" in argv)
    import rtw as rt

    ids = [int(a) for a in argv if a != "--cpu"] or sorted(WORKLOADS)
    report = {"device": device}
    for sid in ids:
        nx, ny, spp = WORKLOADS[sid]
        scene = rt.build_scene(sid, nx, ny)
        entry = {}
        for sched in ("queue", "regen"):
            cfg = rt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=20,
                                  scene_id=sid, scheduler=sched,
                                  bounce_stats=True, occupancy_trace=True)
            rt.render(scene, cfg)            # warm-up, identical config
            m = {}
            img = rt.render(scene, cfg, metrics=m)
            assert np.isfinite(np.asarray(img)).all()
            entry[sched] = {
                "mrays_per_sec": round(m["mrays_per_sec"], 2),
                "wavefront_iterations": m["wavefront_iterations"],
                "mean_occupancy": round(m["mean_occupancy"], 3),
                "rays_by_depth": [round(x) for x in m["rays_by_depth"]],
                "occupancy_by_iter": [round(x, 3)
                                      for x in m["occupancy_by_iter"]],
            }
            print(json.dumps({"scene": sid, "scheduler": sched,
                              "iters": m["wavefront_iterations"],
                              "mean_occ": round(m["mean_occupancy"], 3),
                              "mrays": round(m["mrays_per_sec"], 2)}),
                  flush=True)
        report[str(sid)] = {"workload": [nx, ny, spp], **entry}

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {os.path.normpath(OUT)}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
