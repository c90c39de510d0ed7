"""Per-op time decomposition of one scene's render from a jax.profiler
trace.

Captures a profiler trace of a warm render on the GPU, parses the perfetto
JSON the profiler writes, and aggregates the GPU device planes' op
durations by a coarse bucket map (trace kernel / occlusion kernel / atlas
gathers / flush scatters / fusions).  Buckets are keyed on XLA op names,
which are stable enough across rebuilds for A/B comparison; anything
unmatched lands in `other` so the table always sums to the device total.

Run: python tools/profile_scene.py 4 [--spp 8]
Prints one JSON line: bucket -> total ms on device for the traced render;
the trace itself stays under chiprun_out/profile_scene<N>/.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BUCKETS = (
    # (bucket, substrings matched against the op/kernel name, first wins)
    ("trace_kernel", ("trace_nearest",)),
    ("occl_kernel", ("trace_occluded",)),
    ("gather", ("gather",)),
    ("scatter", ("scatter",)),
    ("cumsum_scan", ("reduce-window", "reduce_window")),
    ("copy_transpose", ("copy", "transpose", "bitcast")),
    ("fusion", ("fusion", "loop_")),
)


def bucket_of(name: str) -> str:
    low = name.lower()
    for b, keys in BUCKETS:
        if any(k in low for k in keys):
            return b
    return "other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", type=int)
    ap.add_argument("--spp", type=int, default=0, help="0 = workload table")
    ap.add_argument("--overrides", nargs="*", default=[])
    args = ap.parse_args()

    from tools.bench_scenes import WORKLOADS, _coerce, require_device

    require_device(False)

    import rtw as rt
    from rtw.utils.profiling import trace

    nx, ny, spp = WORKLOADS[args.scene]
    if args.spp:
        spp = args.spp
    ov = {}
    for a in args.overrides:
        k, v = a.split("=", 1)
        ov[k] = _coerce(v)
    cfg = rt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=20,
                          scene_id=args.scene, **ov)
    scene = rt.build_scene(args.scene, nx, ny)
    rt.render(scene, cfg)            # warm-up/compile outside the trace

    log_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out",
        f"profile_scene{args.scene}")
    with trace(log_dir):
        m = {}
        rt.render(scene, cfg, metrics=m)

    files = glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                      recursive=True)
    if not files:
        print(json.dumps({"error": "no trace written", "dir": log_dir}))
        return 1
    with gzip.open(sorted(files)[-1], "rt") as f:
        tr = json.load(f)

    # device-side complete events: pids whose process names are GPU device
    # planes ("/device:GPU:0 ..."), not python/host threads
    pid_name = {}
    for ev in tr.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_name[ev["pid"]] = ev["args"].get("name", "")
    dev_pids = {p for p, n in pid_name.items()
                if "/device:gpu" in n.lower()}

    agg: dict[str, float] = {}
    count: dict[str, int] = {}
    top: dict[str, float] = {}
    for ev in tr.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("pid") not in dev_pids:
            continue
        name = ev.get("name", "")
        dur_ms = ev.get("dur", 0) / 1000.0
        b = bucket_of(name)
        agg[b] = agg.get(b, 0.0) + dur_ms
        count[b] = count.get(b, 0) + 1
        top[name] = top.get(name, 0.0) + dur_ms

    out = {
        "scene": args.scene, "spp": spp, **ov, "device": m["device_kind"],
        "mrays_per_sec": m["mrays_per_sec"],
        "wall_ms": m["wall_seconds"] * 1000,
        "device_ms": {k: v for k, v in
                      sorted(agg.items(), key=lambda kv: -kv[1])},
        "top_ops_ms": {k: v for k, v in
                       sorted(top.items(), key=lambda kv: -kv[1])[:12]},
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
