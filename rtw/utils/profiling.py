"""Tracing / profiling / observability (SURVEY §5).

The reference's only instrumentation is a wall-clock print (main.cpp:147-160)
plus the OptiX log callback.  Here:

- `trace(dir)`: context manager around `jax.profiler` — captures a Perfetto/
  XPlane trace of everything inside (kernels show up annotated; view with
  TensorBoard or ui.perfetto.dev).
- `annotate(name)`: `jax.profiler.TraceAnnotation` passthrough for marking
  host-side phases (scene build, checkpoint IO) inside a capture.
- `Phases`: cheap wall-clock phase timers (device-synced) for the metrics
  sidecar; `render(..., metrics=...)` already reports rays/samples
  throughput, and the CLI's `--metrics-json` writes the sidecar next to the
  image.
- `device_memory()`: live/peak HBM from the backend, when the platform
  exposes it.
"""

from __future__ import annotations

import contextlib
import json
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace of the enclosed block into `log_dir`."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named host-side annotation visible in captured traces."""
    return jax.profiler.TraceAnnotation(name)


class Phases:
    """Device-synced wall-clock phase timers.

    >>> ph = Phases()
    >>> with ph("scene_build"): scene = build_scene(...)
    >>> with ph("render"): img = render(scene, cfg)
    >>> ph.as_dict()   # {'scene_build_s': ..., 'render_s': ...}
    """

    def __init__(self, sync: bool = True):
        self._sync = sync
        self._times: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                (jax.device_put(0.0) + 0).block_until_ready()
            self._times[name] = (self._times.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def as_dict(self) -> dict:
        return {f"{k}_s": round(v, 4) for k, v in self._times.items()}


def device_memory() -> dict:
    """Live/peak HBM bytes per device, if the backend reports memory stats."""
    out = {}
    for dev in jax.local_devices():
        try:
            stats = dev.memory_stats()
        except Exception:
            continue
        if stats:
            out[str(dev.id)] = {
                "bytes_in_use": stats.get("bytes_in_use"),
                "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                "bytes_limit": stats.get("bytes_limit"),
            }
    return out


def write_metrics(path: str, metrics: dict, phases: "Phases | None" = None):
    """JSON metrics sidecar (render stats + phase timers + HBM)."""
    doc = dict(metrics)
    if phases is not None:
        doc.update(phases.as_dict())
    mem = device_memory()
    if mem:
        doc["device_memory"] = mem
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, default=float)
