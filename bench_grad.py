"""Backward-pass + headline-frame benchmarks on the GPU.

Round-1 VERDICT missing #1: BASELINE demands "forward+backward kernels must
hit speed-of-light per chip" and names the 512^2 x 128 spp frame time, but
bench.py times the forward path only. This script measures, on one chip:

  1. sphere 512^2 @ 8 spp, 5 bounces — jitted LOSS (forward-only) time
  2. same config — jitted value_and_grad step time + backward/forward ratio
  3. sphere 512^2 @ 128 spp — full tonemapped-frame delivery time
     (the BASELINE headline metric), in spp chunks

Prints one JSON line per metric. Traversal mode is 'auto'.
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def _best_of(fn, n=3):
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from polaris_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from polaris_tpu.asset.camera import Camera
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene
    from polaris_tpu.render.grad import DifferentiableRenderer
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions

    obj = os.path.join(HERE, "scenes", "sphere.obj")
    if not os.path.exists(obj):
        import subprocess

        subprocess.run(
            [sys.executable, os.path.join(HERE, "scenes", "generate.py")],
            check=True,
        )
    scene = compile_scene(read_scene(obj))
    results = []

    # ---- 1+2: forward loss vs grad step at 512^2 @ 8 spp ----
    opt = RenderOptions(
        width=512, height=512, spp=8, num_bounces=5, min_bounces_for_rr=3
    )
    r = DifferentiableRenderer(scene, mode="auto")
    cam = Camera.from_scene(scene, opt.width, opt.height)
    cam_params = {
        "frustum": jnp.asarray(cam.frustum),
        "eye": jnp.asarray(cam.position),
    }
    target = jnp.zeros((opt.height, opt.width, 3), jnp.float32)
    seed = jnp.uint32(opt.seed)

    fwd = r.loss_only(opt)
    t0 = time.perf_counter()
    fwd(r.params, cam_params, r.geom, seed, target).block_until_ready()
    print(f"# forward compile: {time.perf_counter()-t0:.1f}s", file=sys.stderr)
    fwd_s = _best_of(
        lambda: fwd(r.params, cam_params, r.geom, seed, target).block_until_ready()
    )

    vg = r._loss_fn(opt)
    t0 = time.perf_counter()
    loss, (gp, gc) = vg(r.params, cam_params, r.geom, seed, target)
    jax.block_until_ready((loss, gp, gc))
    print(f"# grad compile: {time.perf_counter()-t0:.1f}s", file=sys.stderr)
    assert np.isfinite(float(loss))
    assert all(np.isfinite(np.asarray(v)).all() for v in gp.values())

    def grad_step():
        out = vg(r.params, cam_params, r.geom, seed, target)
        jax.block_until_ready(out)

    grad_s = _best_of(grad_step)

    rays = opt.width * opt.height * opt.spp * opt.num_bounces * 2
    results.append(
        {
            "metric": "sphere_512x512_8spp_forward_loss_ms",
            "value": round(fwd_s * 1e3, 1),
            "unit": "ms",
            "mrays_per_s": round(rays / fwd_s / 1e6, 2),
        }
    )
    results.append(
        {
            "metric": "sphere_512x512_8spp_grad_step_ms",
            "value": round(grad_s * 1e3, 1),
            "unit": "ms",
            "backward_forward_ratio": round(grad_s / fwd_s, 2),
            "loss": float(loss),
        }
    )

    # ---- 3: the BASELINE headline — 512^2 x 128 spp frame time ----
    opt128 = RenderOptions(
        width=512, height=512, spp=128, num_bounces=5, min_bounces_for_rr=3
    )
    # regen: estimator-exact wavefront path regeneration (see bench.py note)
    tr = TpuRenderer(scene, mode="auto", regen=True)
    # wider chunks amortize regen's straggler tail
    tr.spp_per_launch = 32
    tr.render_u8(opt128)  # warmup/compile
    frame_s = _best_of(lambda: tr.render_u8(opt128), n=2)
    rays128 = opt128.width * opt128.height * opt128.spp * opt128.num_bounces * 2
    results.append(
        {
            "metric": "sphere_512x512_128spp_frame_s",
            "value": round(frame_s, 3),
            "unit": "s",
            "mrays_per_s": round(rays128 / frame_s / 1e6, 2),
        }
    )

    for row in results:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
