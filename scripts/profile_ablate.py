"""End-to-end ablation timings of the REAL render program on the GPU.

Compiles bench-shaped variants of the full integrator and reports marginal
costs derived from differences — the only measurement that survives XLA
fusion/hoisting:

  * bounces 1 vs 5      -> marginal cost per bounce (closest+shade+NEE+miss)
  * NEE off (no lights) -> the any_hit pass + NEE shading share
  * traversal mode off  -> shade-only share (brute small? no — skipped)

Usage: python scripts/profile_ablate.py [--res 512] [--spp 8]
"""

import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import jax

from polaris_tpu.asset.compiler.compiler import compile_scene
from polaris_tpu.asset.wavefront import read_scene
from polaris_tpu.render.integrator import TpuRenderer
from polaris_tpu.render.options import RenderOptions


def timeit(r, opt, reps=3):
    np.asarray(r.render_accum(opt))  # compile+warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(r.render_accum(opt))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--scene", default=os.path.join(HERE, "scenes", "sphere.obj"))
    args = ap.parse_args()

    scene = compile_scene(read_scene(args.scene))
    W = H = args.res

    def opt(b):
        return RenderOptions(
            width=W, height=H, spp=args.spp, num_bounces=b, min_bounces_for_rr=3
        )

    r = TpuRenderer(scene, mode="auto")
    t5 = timeit(r, opt(5))
    t1 = timeit(r, opt(1))
    print(f"full    b=5: {t5*1e3:8.1f} ms   b=1: {t1*1e3:8.1f} ms   "
          f"marginal/bounce: {(t5-t1)/4*1e3:6.1f} ms  (spp={args.spp})")

    # NEE off: pretend there are no emissives (wrong image, right timing)
    r2 = TpuRenderer(scene, mode="auto")
    r2.num_emissives = 0
    t5n = timeit(r2, opt(5))
    t1n = timeit(r2, opt(1))
    print(f"NEE off b=5: {t5n*1e3:8.1f} ms   b=1: {t1n*1e3:8.1f} ms   "
          f"marginal/bounce: {(t5n-t1n)/4*1e3:6.1f} ms")
    print(f"NEE share per bounce (any_hit + NEE shade): "
          f"{((t5-t1)-(t5n-t1n))/4*1e3:6.1f} ms")

    per_sample5 = t5 / args.spp
    print(f"\nper-sample (5 bounces): {per_sample5*1e3:6.1f} ms")

    # ---- in-program loops isolating traversal vs shading ----
    import jax.numpy as jnp

    from polaris_tpu.asset.camera import Camera
    from polaris_tpu.ops import rng
    from polaris_tpu.ops import vec as V
    from polaris_tpu.render.integrator import blocked_pixel_order
    from polaris_tpu.render.raygen import gen_rays
    from polaris_tpu.render.shade import shade

    S = {**r.geom, **r.params}
    n = W * H
    cam = Camera.from_scene(scene, W, H)
    xs, ys, pix, _ = blocked_pixel_order(W, H)
    xs, ys, pix = jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(pix)
    seed = jnp.uint32(7)
    fr, eye = jnp.asarray(cam.frustum), jnp.asarray(cam.position)
    maxt = jnp.full(n, V.FLT_MAX, jnp.float32)

    def trav_only(sample_count):
        def sample_body(s, acc):
            U0 = rng.make_uniform(rng.jnp_uniform, seed, pix, s, 0)
            o, d = gen_rays(jnp, fr, eye, W, H, xs, ys, U0)
            alive = jnp.ones(n, bool)

            def bounce(c, b):
                o, d, acc = c
                hit = r.closest(S, o, d, maxt, alive)
                # cheap fake shading: bounce off with a hit-dependent dir
                o2 = o + jnp.where(hit.mask, hit.t, 1.0)[..., None] * d
                d2 = V.normalize3(
                    jnp, d + jnp.stack([hit.u, hit.v, hit.t * 0 + 0.3], -1)
                )
                return (o2, d2, acc + jnp.sum(hit.t)), None

            (o, d, acc2), _ = jax.lax.scan(
                bounce, (o, d, jnp.float32(0.0)), jnp.arange(5, dtype=jnp.uint32)
            )
            return acc + acc2

        return jax.jit(
            lambda: jax.lax.fori_loop(0, sample_count, sample_body, jnp.float32(0))
        )

    def shade_only(sample_count):
        # fixed hit data from one real primary pass
        U0 = rng.make_uniform(rng.jnp_uniform, seed, pix, jnp.int32(0), 0)
        o0, d0 = gen_rays(jnp, fr, eye, W, H, xs, ys, U0)
        hit0 = r.closest(S, o0, d0, maxt, jnp.ones(n, bool))
        hit0 = jax.tree.map(jax.block_until_ready, hit0)
        t0v = jnp.where(hit0.mask, hit0.t, 0.0)

        def sample_body(s, acc):
            tp = jnp.ones((n, 3), jnp.float32)
            fl = jnp.zeros(n, jnp.uint32)
            o, d = o0, d0

            def bounce(c, b):
                o, d, tp, fl, acc = c
                U = rng.make_uniform(rng.jnp_uniform, seed, pix, s, b)
                out = shade(
                    jnp, S, U, bounce=b, min_bounces_for_rr=3,
                    num_emissives=r.num_emissives,
                    material_depth=r.material_depth,
                    ray_o=o, ray_d=d, t=t0v, inst=hit0.inst, tri=hit0.tri,
                    bary_u=hit0.u, bary_v=hit0.v, hit_mask=hit0.mask,
                    throughput=tp, flags=fl,
                )
                return (
                    out["next_o"], out["next_d"], out["throughput"], out["flags"],
                    acc + jnp.sum(out["occl_value"]) + jnp.sum(out["emit_add"]),
                ), None

            (o, d, tp, fl, acc2), _ = jax.lax.scan(
                bounce, (o, d, tp, fl, jnp.float32(0.0)),
                jnp.arange(5, dtype=jnp.uint32),
            )
            return acc + acc2

        return jax.jit(
            lambda: jax.lax.fori_loop(0, sample_count, sample_body, jnp.float32(0))
        )

    for name, mk in (("traversal-only", trav_only), ("shade-only", shade_only)):
        fn = mk(args.spp)
        jax.block_until_ready(fn())
        best = float("inf")
        for _ in range(3):
            tt = time.perf_counter()
            jax.block_until_ready(fn())
            best = min(best, time.perf_counter() - tt)
        print(f"{name:15s} 5 bounces x {args.spp} spp: {best*1e3:8.1f} ms "
              f"({best/args.spp/5*1e3:5.2f} ms/bounce/sample)")


if __name__ == "__main__":
    main()
