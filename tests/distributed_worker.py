"""Subprocess worker for the multi-process distributed tests (SURVEY §4
tier 5: exercise the jax.distributed DCN bootstrap with local processes).

Invoked as:
  python distributed_worker.py <pid> <nproc> <port> <out.npy>
      [devices_per_proc] [spp] [checkpoint_path]

Each process contributes `devices_per_proc` virtual CPU devices to a
global 1-D mesh, renders scene 5 pixel-sharded, and process 0 writes the
image.  With a checkpoint path the accumulator persists every chunk
(spp_chunk=1), so a SIGKILL mid-render leaves a resumable state and a
relaunch with the same arguments completes the render bit-exactly."""

import os
import sys


def main():
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    port, out_path = sys.argv[3], sys.argv[4]
    dev_per_proc = int(sys.argv[5]) if len(sys.argv) > 5 else 1
    spp = int(sys.argv[6]) if len(sys.argv) > 6 else 4
    ckpt = sys.argv[7] if len(sys.argv) > 7 else None

    if dev_per_proc > 1:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={dev_per_proc}")

    import jax
    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from rtw import RenderConfig, build_scene
    from rtw.parallel.mesh import (init_distributed, make_mesh,
                                       render_sharded)

    init_distributed(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc
    assert len(jax.devices()) == nproc * dev_per_proc

    cfg = RenderConfig(nx=32, ny=24, spp=spp, max_depth=6, scene_id=5,
                       backend="jnp", scheduler="regen",
                       spp_chunk=1 if ckpt else 0)
    scene = build_scene(5, cfg.nx, cfg.ny)
    img = render_sharded(scene, cfg, make_mesh(),
                         checkpoint_path=ckpt,
                         checkpoint_every=1 if ckpt else 0)
    if pid == 0:
        import numpy as np

        np.save(out_path, np.asarray(img))
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
