"""Per-pass device-time profile on the GPU.

Times each pipeline stage (primary closest, bounce-N closest, shadow any-hit,
shading) with *realistic* ray distributions: rays are produced by actually
running the preceding bounces. Each stage is repeated K times inside one
jitted scan (with a data-dependent perturbation so XLA cannot CSE the
repeats), so the dispatch cost amortizes away and the number reported is
device time per pass.

Usage: python scripts/profile_passes.py [--res 512] [--reps 16]
"""

import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import jax
import jax.numpy as jnp

from polaris_tpu.asset.compiler.compiler import compile_scene
from polaris_tpu.asset.camera import Camera
from polaris_tpu.asset.wavefront import read_scene
from polaris_tpu.ops import rng
from polaris_tpu.ops import vec as V
from polaris_tpu.ops.intersect import make_intersectors
from polaris_tpu.render.integrator import blocked_pixel_order
from polaris_tpu.render.raygen import gen_rays
from polaris_tpu.render.shade import shade


def timed(fn, *args, reps=3):
    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--reps", type=int, default=16, help="in-jit repeats")
    ap.add_argument("--scene", default=os.path.join(HERE, "scenes", "sphere.obj"))
    args = ap.parse_args()

    scene = compile_scene(read_scene(args.scene))
    from polaris_tpu.render.integrator import TpuRenderer

    r = TpuRenderer(scene, mode="auto")
    S = {**r.geom, **r.params}
    closest, any_hit = r.closest, r.any_hit
    W = H = args.res
    n = W * H
    cam = Camera.from_scene(scene, W, H)
    xs, ys, pix, _ = blocked_pixel_order(W, H)
    xs, ys, pix = jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(pix)
    seed = jnp.uint32(7)
    K = args.reps

    def repeat_closest(fn):
        def run(o, d, maxt, act):
            def body(c, _):
                s, acc = c
                hit = fn(S, o + s, d, maxt, act)
                ssum = jnp.sum(hit.t) * 0.0
                return (ssum, acc + jnp.sum(hit.t)), None

            (s, acc), _ = jax.lax.scan(
                body, (jnp.float32(0.0), jnp.float32(0.0)), None, length=K
            )
            return acc

        return jax.jit(run)

    # ---- build realistic per-bounce ray states by running the pipeline ----
    U0 = rng.make_uniform(rng.jnp_uniform, seed, pix, jnp.int32(0), 0)
    ray_o, ray_d = gen_rays(
        jnp, jnp.asarray(cam.frustum), jnp.asarray(cam.position), W, H, xs, ys, U0
    )
    maxt = jnp.full(n, V.FLT_MAX, jnp.float32)
    alive = jnp.ones(n, bool)
    throughput = jnp.ones((n, 3), jnp.float32)
    flags = jnp.zeros(n, jnp.uint32)

    shade_jit = jax.jit(
        lambda o, d, t, inst, tri, u, v, hm, tp, fl, b: shade(
            jnp,
            S,
            rng.make_uniform(rng.jnp_uniform, seed, pix, jnp.int32(0), b),
            bounce=b,
            min_bounces_for_rr=3,
            num_emissives=r.num_emissives,
            material_depth=r.material_depth,
            ray_o=o,
            ray_d=d,
            t=t,
            inst=inst,
            tri=tri,
            bary_u=u,
            bary_v=v,
            hit_mask=hm,
            throughput=tp,
            flags=fl,
        ),
        static_argnames=(),
    )

    rows = []
    closest_rep = repeat_closest(closest)
    any_rep = repeat_closest(
        lambda S_, o, d, m, a: type(
            "H", (), {"t": any_hit(S_, o, d, m, a).astype(jnp.float32)}
        )()
    )

    state = (ray_o, ray_d, throughput, flags, alive)
    for b in range(4):
        o, d, tp, fl, act = state
        best, _ = timed(closest_rep, o, d, maxt, act)
        occup = float(jnp.mean(act.astype(jnp.float32)))
        rows.append((f"closest bounce {b} (occ {occup:.2f})", best / K))
        hit = closest(S, o, d, maxt, act)
        hit = jax.tree.map(jax.block_until_ready, hit)
        t = jnp.where(hit.mask, hit.t, 0.0)
        out = shade_jit(
            o, d, t, hit.inst, hit.tri, hit.u, hit.v, hit.mask, tp, fl, jnp.uint32(b)
        )
        # shading time
        def shade_rep(o_, d_, t_, inst_, tri_, u_, v_, hm_, tp_, fl_):
            def body(c, _):
                s, acc = c
                out_ = shade_jit(o_ + s, d_, t_, inst_, tri_, u_, v_, hm_, tp_, fl_,
                                 jnp.uint32(b))
                ssum = jnp.sum(out_["next_o"]) * 0.0
                return (ssum, acc + jnp.sum(out_["throughput"])), None

            (s, acc), _ = jax.lax.scan(
                body, (jnp.float32(0.0), jnp.float32(0.0)), None, length=K
            )
            return acc

        best, _ = timed(jax.jit(shade_rep), o, d, t, hit.inst, hit.tri, hit.u,
                        hit.v, hit.mask, tp, fl)
        rows.append((f"shade   bounce {b}", best / K))
        om = out["occl_mask"]
        occ = float(jnp.mean(om.astype(jnp.float32)))
        best, _ = timed(any_rep, out["occl_o"], out["occl_d"], out["occl_maxt"], om)
        rows.append((f"any_hit bounce {b} (occ {occ:.2f})", best / K))
        state = (out["next_o"], out["next_d"], out["throughput"], out["flags"],
                 out["next_mask"])

    print(f"\n== per-pass device time, {W}x{H} ({n} lanes), reps={K} ==")
    total = 0.0
    for name, sec in rows:
        total += sec
        print(f"{name:36s} {sec * 1e3:8.2f} ms")
    print(f"{'TOTAL (4 bounces)':36s} {total * 1e3:8.2f} ms")


if __name__ == "__main__":
    main()
