"""On-card smoke test of the path tracer's main path.

    python chip_smoke.py               # phases (a)-(d) on one GPU
    python chip_smoke.py --four-cards  # sharded render/gradient on 4 GPUs

Phases (one card):

(a) device  — JAX's default backend must be "gpu"; otherwise the script
              exits nonzero before anything else runs.
(b) parity  — the six golden renders of tests/test_goldens.py (64x48,
              32 spp, regen) against tests/goldens/scene*.npz.  Gated on
              the test's channel-mean band (rtol 0.02, atol 0.003).  The
              per-pixel error is reported, not gated: the GPU's libdevice
              transcendentals and FMA contraction differ from the CPU's in
              the last bits, and one ulp in a hit point re-routes a whole
              Monte Carlo path, so pixels diverge while the estimator
              (the channel means) agrees.
(c) kernel  — the Pallas-Triton trace kernels against the XLA jnp sweep on
              camera rays and first-bounce rays of scenes 1, 2 and 4 at
              1200x600.  Gated: prim_idx agreement >= 0.999, and on rays
              that agree, >= 0.9999 of hits with |dt| <= 2e-4 |t| (the rtol
              of tests/test_trace_kernel.py: grazing hits amplify FMA
              contraction differences through the quadratic's
              cancellation); occlusion agreement >= 0.999.
(d) renders — Cornell 800x800 depth 20 through rtw.render() and the CLI,
              scene 4 at 1200x600 depth 20 through the CLI with --denoise
              (the reference's default deployment), one gradient step of
              diff.make_loss_and_grad on Cornell; all with 'auto' dispatch.
              Gated: finite and not black.

--four-cards runs only the sharded path (render_sharded in pixels and
samples mode, grad_sharded) against the single-card results.

Every phase prints its wall time, compile time and Mrays/s where rays are
counted; a failed phase makes the script exit nonzero without the final
JSON line.  Images and a summary go to chiprun_out/smoke/.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out", "smoke")


def _log(*a):
    print(*a, flush=True)


def _twice(fn):
    """(result, first_s, warm_s): fn() run cold (compiles) then warm; the
    difference of the two is the compile (and first-transfer) time."""
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    out = fn()
    return out, t1 - t0, time.perf_counter() - t1


def _fmt(d):
    return " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in d.items())


# ---------------------------------------------------------------------------
# (b) parity against the CPU goldens
# ---------------------------------------------------------------------------

def phase_parity(scenes=range(6)):
    import numpy as np
    import rtw as rt
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_goldens import CFG, EXPECTED, GOLDEN_DIR

    res = {}
    for sid in scenes:
        cfg = rt.RenderConfig(scene_id=sid, **CFG)
        scene = rt.build_scene(sid, cfg.nx, cfg.ny)
        t0 = time.perf_counter()
        img = np.asarray(rt.render(scene, cfg))
        wall = time.perf_counter() - t0
        with np.load(os.path.join(GOLDEN_DIR, f"scene{sid}.npz")) as z:
            ref = z["img"]
        got = img.reshape(-1, 3).mean(axis=0)
        err = np.abs(img - ref)
        ok = bool(np.isfinite(img).all() and np.allclose(
            got, EXPECTED[sid], rtol=0.02, atol=0.003))
        res[sid] = dict(ok=ok, means=got.tolist(),
                        expected=EXPECTED[sid],
                        frac_px_over_1e4=float((err > 1e-4).mean()),
                        max_err=float(err.max()), wall_s=wall)
        _log(f"  (b) scene {sid}: {_fmt(res[sid])} (wall is compile + "
             f"render)")
        assert ok, f"scene {sid} channel means {got} vs {EXPECTED[sid]}"
    return res


# ---------------------------------------------------------------------------
# (c) trace kernels against the XLA sweep
# ---------------------------------------------------------------------------

def _ray_sets(scene, cfg, key):
    """Camera rays and the first-bounce rays (dead lanes: tmax = -BIG)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from rtw.integrator import bounce_step, generate_camera_rays
    from rtw.ops.intersect import BIG
    from rtw.utils import rng as R

    pix = jnp.arange(cfg.num_pixels, dtype=jnp.int32)
    keys = R.make_path_keys(key, pix, jnp.zeros_like(pix), cfg.rng)
    cam = generate_camera_rays(scene, cfg, pix, keys)
    nxt = jax.jit(lambda s: bounce_step(scene, cfg, keys, s, 0))(cam)
    full = jnp.full((cfg.num_pixels,), np.float32(cfg.t_max))
    return {"camera": (cam, full),
            "bounce1": (nxt, jnp.where(nxt.alive, full, -BIG))}


def _warm_ms(fn, args, reps=3):
    """(result, best warm milliseconds) of jit(fn)(*args); args[3] (the
    ray epsilon) is static."""
    import jax

    f = jax.jit(fn, static_argnums=(3,))
    out = jax.block_until_ready(f(*args))          # compile + first run
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best * 1e3


def phase_kernel(scenes=(1, 2, 4), nx=1200, ny=600):
    import numpy as np
    import jax
    import jax.numpy as jnp
    import rtw as rt
    from rtw.ops import intersect as I
    from rtw.ops import trace_kernel as TK
    from rtw.utils import rng as R

    res = {}
    for sid in scenes:
        cfg = rt.RenderConfig(nx=nx, ny=ny, scene_id=sid, backend="jnp")
        scene = rt.build_scene(sid, nx, ny)
        key = R.base_key(7)
        for name, (st, tmax) in _ray_sets(scene, cfg, key).items():
            n = cfg.num_pixels
            o, d, tm = st.origin, st.direction, st.time
            vu = jax.random.uniform(jax.random.PRNGKey(sid),
                                    (max(scene.n_vol, 1), n))
            args = (scene, o, d, cfg.t_min, tmax, tm, vu)
            (ref_t, ref_i), ms_x = _warm_ms(I.nearest, args)
            (k_t, k_i), ms_k = _warm_ms(TK.nearest_pallas, args)
            ref_t, ref_i, k_t, k_i = map(np.asarray, (ref_t, ref_i, k_t, k_i))
            agree = ref_i == k_i
            hit = agree & (ref_i >= 0)
            rel = np.abs(k_t[hit] - ref_t[hit]) / np.maximum(
                np.abs(ref_t[hit]), 1e-30)
            # shadow-style queries: tmax drawn around the nearest hit, so
            # both outcomes occur
            u = np.random.default_rng(sid).uniform(0.0, 2.0, n)
            otmax = jnp.asarray(np.where(np.asarray(tmax) < 0, -I.BIG,
                                         u * np.minimum(ref_t, 1e4)),
                                jnp.float32)
            args = (scene, o, d, cfg.shadow_eps, otmax, tm, vu)
            ref_o, ms_ox = _warm_ms(I.occluded, args)
            k_o, ms_ok = _warm_ms(TK.occluded_pallas, args)
            ref_o, k_o = np.asarray(ref_o), np.asarray(k_o)
            r = dict(prim_agree=float(agree.mean()),
                     hit_frac=float((ref_i >= 0).mean()),
                     t_within_2e4=float((rel <= 2e-4).mean()) if rel.size
                     else 1.0,
                     t_max_rel=float(rel.max()) if rel.size else 0.0,
                     occl_agree=float((ref_o == k_o).mean()),
                     occl_frac=float(ref_o.mean()),
                     nearest_ms_xla=ms_x, nearest_ms_kernel=ms_k,
                     occluded_ms_xla=ms_ox, occluded_ms_kernel=ms_ok)
            r["ok"] = bool(r["prim_agree"] >= 0.999
                           and r["t_within_2e4"] >= 0.9999
                           and r["occl_agree"] >= 0.999)
            res[f"scene{sid}_{name}"] = r
            _log(f"  (c) scene {sid} {name}: {_fmt(r)}")
    bad = [k for k, v in res.items() if not v["ok"]]
    assert not bad, f"kernel disagrees with the XLA sweep: {bad}"
    return res


# ---------------------------------------------------------------------------
# (d) main-path renders
# ---------------------------------------------------------------------------

def _check_image(img, what):
    import numpy as np

    img = np.asarray(img)
    assert np.isfinite(img).all(), f"{what}: non-finite pixels"
    assert float(img.mean()) > 1e-3, f"{what}: black image"
    return float(img.mean())


def phase_renders(cornell_spp=256, cornell_px=800, s4_spp=20, grad_px=800):
    import numpy as np
    import jax
    import jax.numpy as jnp
    import rtw as rt
    from rtw import cli
    from rtw.diff import extract_params, make_loss_and_grad
    from rtw.utils import rng as R
    from rtw.utils.image import decode_png

    os.makedirs(OUT, exist_ok=True)
    res = {}

    def cli_png(name, argv):
        png = os.path.join(OUT, name)
        t0 = time.perf_counter()
        rc = cli.main(argv + ["-o", png])
        wall = time.perf_counter() - t0
        assert rc == 0, f"cli {argv}: rc={rc}"
        with open(png, "rb") as f:
            mean = _check_image(decode_png(f.read()) / 255.0, name)
        return wall, mean, png

    def warm_render(what, sid, nx, ny, spp, first_wall):
        """render() with the config the CLI built — already compiled, so
        this is a warm timing; compile ~ CLI wall - warm wall."""
        cfg = rt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=20,
                              scene_id=sid)
        m = {}
        mean = _check_image(rt.render(rt.build_scene(sid, nx, ny), cfg,
                                      metrics=m), what)
        r = dict(cli_wall_s=first_wall, render_wall_s=m["wall_seconds"],
                 compile_s=first_wall - m["wall_seconds"],
                 mrays=m["mrays_per_sec"], mean=mean,
                 platform=m["platform"], device_kind=m["device_kind"])
        _log(f"  (d) {what}: {_fmt(r)}")
        return r

    wall, mean, png = cli_png("cornell.png", [
        "-s", "0", "-dx", str(cornell_px), "-dy", str(cornell_px),
        "-ns", str(cornell_spp)])
    _log(f"  (d) cli cornell {cornell_px}^2 {cornell_spp} spp: "
         f"wall={wall:.2f}s mean={mean:.4f} -> {png}")
    res["cornell"] = warm_render(f"render() cornell {cornell_px}^2 "
                                 f"{cornell_spp} spp", 0, cornell_px,
                                 cornell_px, cornell_spp, wall)

    # the reference's default deployment: scene 4, 1200x600, depth 20
    wall, mean, png = cli_png("scene4_denoised.png", [
        "-s", "4", "-ns", str(s4_spp), "--denoise"])
    _log(f"  (d) cli scene 4 1200x600 {s4_spp} spp --denoise: "
         f"wall={wall:.2f}s mean={mean:.4f} -> {png}")
    res["scene4"] = warm_render(f"render() scene 4 1200x600 {s4_spp} spp",
                                4, 1200, 600, s4_spp, wall)

    # one gradient step on Cornell
    gcfg = rt.RenderConfig(nx=grad_px, ny=grad_px, spp=1, max_depth=20,
                           scene_id=0, differentiable=True)
    gscene = rt.build_scene(0, grad_px, grad_px)
    pix = jnp.arange(gcfg.num_pixels, dtype=jnp.int32)
    params = extract_params(gscene)
    target = jnp.zeros((gcfg.num_pixels, 3), jnp.float32)
    step = make_loss_and_grad(gscene, gcfg, 1)
    (loss, grads), first, warm = _twice(lambda: jax.block_until_ready(
        step(params, target, pix, R.base_key(0))))
    leaves = jax.tree_util.tree_leaves(grads)
    assert np.isfinite(float(loss)), "grad step: non-finite loss"
    assert all(np.isfinite(np.asarray(x)).all() for x in leaves), \
        "grad step: non-finite gradient"
    gnorm = float(sum(float(jnp.sum(jnp.abs(x))) for x in leaves))
    assert gnorm > 0.0, "grad step: zero gradient"
    res["grad"] = dict(first_s=first, warm_s=warm, compile_s=first - warm,
                       loss=float(loss), grad_l1=gnorm)
    _log(f"  (d) grad step cornell {grad_px}^2 depth 20: {_fmt(res['grad'])}")
    return res


# ---------------------------------------------------------------------------
# four cards: sharded render and gradient against one card
# ---------------------------------------------------------------------------

def phase_four_cards(n_dev=4, cornell=(800, 800, 256), s4=(1200, 600, 32),
                     grad_px=200):
    import numpy as np
    import jax
    import jax.numpy as jnp
    import rtw as rt
    from jax.sharding import NamedSharding, PartitionSpec as P
    from rtw.diff import extract_params
    from rtw.parallel.mesh import grad_sharded, make_mesh, render_sharded
    from rtw.utils import rng as R

    devs = jax.devices()
    assert len(devs) >= n_dev, f"need {n_dev} devices, have {len(devs)}"
    mesh = make_mesh(devs[:n_dev])
    res = {}
    for sid, (nx, ny, spp) in ((0, cornell), (4, s4)):
        scene = rt.build_scene(sid, nx, ny)
        # regen pixels mode is bit-identical by design; samples mode (the
        # default scheduler) reassociates per-pixel sums
        for sched, mode in (("regen", "pixels"), ("auto", "samples")):
            cfg = rt.RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=20,
                                  scene_id=sid, scheduler=sched)
            m1, m4 = {}, {}
            one, f1, w1 = _twice(lambda: np.asarray(
                rt.render(scene, cfg, metrics=m1)))
            img, f4, w4 = _twice(lambda: render_sharded(
                scene, cfg, mesh, mode=mode, metrics=m4))
            err = np.abs(img - one)
            # rays/s compares across card counts only if both count the
            # same rays (the f32 per-chunk counters round differently)
            r = dict(bit_identical=bool((img == one).all()),
                     max_abs=float(err.max()),
                     rays_ratio=m4["rays"] / m1["rays"],
                     mrays_1card=m1["mrays_per_sec"],
                     mrays_4card=m4["mrays_per_sec"],
                     scaling=m4["mrays_per_sec"] / (n_dev
                                                    * m1["mrays_per_sec"]),
                     render_s_1=m1["wall_seconds"],
                     render_s_4=m4["wall_seconds"],
                     warm_s_1=w1, warm_s_4=w4, compile_s_1=f1 - w1,
                     compile_s_4=f4 - w4)
            r["ok"] = bool(abs(r["rays_ratio"] - 1.0) <= 1e-4 and (
                r["max_abs"] <= 1e-5 if mode == "pixels" else
                np.allclose(img, one, rtol=1e-4, atol=1e-4)))
            res[f"scene{sid}_{sched}_{mode}"] = r
            _log(f"  (4) scene {sid} {nx}x{ny} {spp} spp {sched} {mode}: "
                 f"{_fmt(r)}")

    # each card holds its own slab of a pixel-sharded array
    x = jax.device_put(jnp.arange(n_dev * 8, dtype=jnp.float32),
                       NamedSharding(mesh, P("data")))
    owners = sorted(sh.device.id for sh in x.addressable_shards)
    sizes = [sh.data.shape[0] for sh in x.addressable_shards]
    res["slabs"] = dict(owners=owners, sizes=sizes, ok=bool(
        owners == sorted(d.id for d in devs[:n_dev])
        and sizes == [8] * n_dev))
    _log(f"  (4) slabs: {_fmt(res['slabs'])}")

    # gradient: 4 cards against 1
    gcfg = rt.RenderConfig(nx=grad_px, ny=grad_px, spp=1, max_depth=8,
                           scene_id=0, differentiable=True)
    gscene = rt.build_scene(0, grad_px, grad_px)
    params = extract_params(gscene)
    target = np.zeros((gcfg.ny, gcfg.nx, 3), np.float32)
    key = R.base_key(0)
    l1, g1 = grad_sharded(gscene, gcfg, make_mesh(devs[:1]), params, target,
                          key, n_samples=1)
    l4, g4 = grad_sharded(gscene, gcfg, mesh, params, target, key,
                          n_samples=1)
    ok = bool(np.isclose(float(l1), float(l4), rtol=1e-4)) and all(
        np.allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(g1),
                        jax.tree_util.tree_leaves(g4)))
    res["grad"] = dict(ok=ok, loss_1=float(l1), loss_4=float(l4))
    _log(f"  (4) grad_sharded {grad_px}^2, 4 cards vs 1: {_fmt(res['grad'])}")
    bad = [k for k, v in res.items() if not v["ok"]]
    assert not bad, f"four-card checks failed: {bad}"
    return res


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded checks")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    from rtw.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    import jax

    # (a) device
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"FAIL (a) device: JAX backend is {backend!r}, not 'gpu'",
              file=sys.stderr)
        return 2
    dev = jax.devices()[0]
    _log(f"nvidia-smi: {_nvidia_smi()}")
    _log(f"(a) device: platform={dev.platform} kind={dev.device_kind} "
         f"count={len(jax.devices())} compile_cache={cache}")

    phases = ([("four_cards", phase_four_cards)] if args.four_cards else
              [("parity", phase_parity), ("kernel", phase_kernel),
               ("renders", phase_renders)])
    summary, failed = {}, []
    for name, fn in phases:
        _log(f"phase {name}:")
        t0 = time.perf_counter()
        try:
            summary[name] = fn()
        except Exception:  # recorded, reported and fails the run below
            failed.append(name)
            summary[name] = {"error": traceback.format_exc()}
            _log(traceback.format_exc())
        _log(f"phase {name}: {'FAILED' if name in failed else 'ok'} "
             f"wall={time.perf_counter() - t0:.2f}s")
    os.makedirs(OUT, exist_ok=True)
    tag = "four_cards" if args.four_cards else "one_card"
    with open(os.path.join(OUT, f"summary_{tag}.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    if failed:
        print(f"FAIL: phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
