"""Per-scene throughput on the GPU.

Each variant of a scene renders once for warm-up (compiles); then the
variants are timed interleaved, A B ... B A, ROUNDS times over, so drift on
the card shows up as spread within each variant.  Every run is reported
with the median and the device it ran on.  Exits nonzero when JAX finds
no GPU, unless --cpu is given.

Usage: python tools/bench_scenes.py [--cpu] [scene_id ...] [variant ...]
(default: all scenes, one variant with no overrides.  A variant is
field=value[,field=value...] of RenderConfig overrides, e.g.
backend=jnp,scheduler=regen.)
"""

import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# scene_id -> (nx, ny, spp)
WORKLOADS = {
    0: (800, 800, 64),
    1: (800, 400, 16),
    2: (800, 400, 16),
    3: (400, 400, 32),
    4: (800, 400, 8),
    5: (400, 224, 64),
}

ROUNDS = 3  # timed A B ... B A passes; each variant runs 2 * ROUNDS times


def nvidia_smi() -> str:
    """The card's name and power limit, or why they are unknown."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except OSError as e:
        return f"nvidia-smi unavailable ({e})"


def require_device(cpu: bool) -> dict:
    """Report the device; exit nonzero unless it is a GPU or --cpu asked
    for the CPU.  Also enables the persistent compile cache."""
    from rtw.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    info = {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}
    print(json.dumps({"device": info, "nvidia_smi": nvidia_smi()}),
          flush=True)
    if dev.platform != "gpu" and not cpu:
        sys.exit(f"no GPU found (platform {dev.platform!r}); pass --cpu "
                 f"to measure the CPU")
    return info


def bench_scene(sid: int, variants: list[dict]) -> list[list[dict]]:
    """render() metrics of every timed run, per variant."""
    from rtw import RenderConfig, build_scene, render

    nx, ny, spp = WORKLOADS[sid]
    scene = build_scene(sid, nx, ny)
    cfgs = [RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=20, scene_id=sid,
                         **v) for v in variants]
    for cfg in cfgs:
        render(scene, cfg)                   # warm-up (identical config)
    runs = [[] for _ in cfgs]
    order = list(range(len(cfgs)))
    for _ in range(ROUNDS):
        for i in order + order[::-1]:
            metrics = {}
            img = render(scene, cfgs[i], metrics=metrics)
            assert np.isfinite(np.asarray(img)).all()
            runs[i].append(metrics)
    return runs


def _coerce(v: str):
    """k=v override values arrive as strings; RenderConfig fields are typed
    (int/float/bool/str), so parse literals where possible."""
    import ast

    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def main(argv):
    cpu = "--cpu" in argv
    argv = [a for a in argv if a != "--cpu"]
    variants = []
    ids = []
    for a in argv:
        if "=" in a:
            variants.append({k: _coerce(v) for k, v in
                             (f.split("=", 1) for f in a.split(","))})
        else:
            ids.append(int(a))
    require_device(cpu)
    variants = variants or [{}]
    for sid in ids or sorted(WORKLOADS):
        for v, runs in zip(variants, bench_scene(sid, variants)):
            mrays = [m["mrays_per_sec"] for m in runs]
            print(json.dumps({
                "scene": sid, **v,
                "mrays_per_sec": float(np.median(mrays)),
                "mrays_runs": mrays,
                "wall_seconds": [m["wall_seconds"] for m in runs],
                "platform": runs[0]["platform"],
                "device_kind": runs[0]["device_kind"],
            }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
