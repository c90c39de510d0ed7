"""Multi-process distributed rendering (SURVEY §4 tier 5).

Spawns 2 local processes that bootstrap over jax.distributed
(mesh.init_distributed -> coordinator on localhost), render scene 5
pixel-sharded across the 2-process global mesh, and asserts the image is
bit-identical to the in-process single-device render — the RNG is keyed by
logical (pixel, sample) only, so process/device topology must not change
the estimator."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import rtw as rt

_WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(nproc, port, out, dev_per_proc=1, spp=4, ckpt=None, env=None):
    env = dict(env or os.environ)
    # workers manage their own platform/device config; drop the test
    # session's 8-virtual-device forcing
    env.pop("XLA_FLAGS", None)
    args = [str(dev_per_proc), str(spp)] + ([ckpt] if ckpt else [])
    return [subprocess.Popen(
        [sys.executable, _WORKER, str(pid), str(nproc), str(port), out]
        + args,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(nproc)]


def _single_image(spp=4, spp_chunk=0):
    cfg = rt.RenderConfig(nx=32, ny=24, spp=spp, max_depth=6, scene_id=5,
                          backend="jnp", scheduler="regen",
                          spp_chunk=spp_chunk)
    return np.asarray(rt.render(rt.build_scene(5, cfg.nx, cfg.ny), cfg))


def test_two_process_render_matches_single():
    port = _free_port()
    out = os.path.join(os.path.dirname(__file__), "_dist_img.npy")
    if os.path.exists(out):
        os.remove(out)

    procs = _launch(2, port, out)
    outs = [p.communicate(timeout=560)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode(errors="replace")[-2000:]
    assert os.path.exists(out), "worker 0 wrote no image"

    img_dist = np.load(out)
    os.remove(out)
    np.testing.assert_array_equal(img_dist, _single_image())


def test_four_process_two_device_render_matches_single():
    """4 processes x 2 virtual CPU devices each = an 8-device global mesh
    spanning process boundaries — the multi-host shape the driver's dryrun
    can't cover (it is single-process)."""
    port = _free_port()
    out = os.path.join(os.path.dirname(__file__), "_dist_img4.npy")
    if os.path.exists(out):
        os.remove(out)

    procs = _launch(4, port, out, dev_per_proc=2)
    outs = [p.communicate(timeout=560)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode(errors="replace")[-2000:]
    assert os.path.exists(out), "worker 0 wrote no image"

    img_dist = np.load(out)
    os.remove(out)
    np.testing.assert_array_equal(img_dist, _single_image())


def test_preempt_resume_bitexact():
    """Failure recovery (SURVEY §5): SIGKILL one process of a checkpointing
    2-process render mid-run (the peer is torn down too — a dead member
    kills a collective job), relaunch the whole job with identical
    arguments, and the resumed render completes to the bit-exact image of
    an uninterrupted single-device run."""
    import signal
    import time

    port = _free_port()
    base = os.path.dirname(__file__)
    out = os.path.join(base, "_dist_img_pr.npy")
    ckpt = os.path.join(base, "_dist_ckpt.npz")
    for f in (out, ckpt):
        if os.path.exists(f):
            os.remove(f)

    spp = 8   # spp_chunk=1 in the worker -> 8 chunks, checkpoint each
    procs = _launch(2, port, out, spp=spp, ckpt=ckpt)
    # kill process 1 the moment the first checkpoint lands
    deadline = time.time() + 300
    while not os.path.exists(ckpt) and time.time() < deadline:
        if any(p.poll() is not None for p in procs):
            break   # finished before we could preempt (or died) — handled below
        time.sleep(0.05)
    preempted = False
    if procs[1].poll() is None:
        procs[1].send_signal(signal.SIGKILL)
        preempted = True
    for p in procs:
        try:
            p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
    assert os.path.exists(ckpt), "no checkpoint was written before preemption"
    if preempted and os.path.exists(out):
        os.remove(out)   # partial job should not have produced the image

    from rtw.utils import checkpoint as ck
    cfg = rt.RenderConfig(nx=32, ny=24, spp=spp, max_depth=6, scene_id=5,
                          backend="jnp", scheduler="regen", spp_chunk=1)
    state = ck.load(ckpt, cfg)
    assert state is not None, "checkpoint does not match the job config"

    # restart the whole job with identical arguments; it must resume
    port2 = _free_port()
    procs = _launch(2, port2, out, spp=spp, ckpt=ckpt)
    outs = [p.communicate(timeout=560)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode(errors="replace")[-2000:]
    assert os.path.exists(out)

    img = np.load(out)
    for f in (out, ckpt):
        os.remove(f)
    np.testing.assert_array_equal(img, _single_image(spp=spp, spp_chunk=1))
