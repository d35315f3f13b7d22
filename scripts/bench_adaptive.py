"""Adaptive-sampling equal-quality benchmark (round-4 VERDICT weak #3).

Claim under test: variance-driven per-block early stop delivers the same
image quality as uniform cornell@64spp in substantially less wall time.
Quality is MSE of the tonemapped image against a 512-spp reference render;
"same" = adaptive MSE <= uniform MSE * (1 + margin). Prints one JSON line
per configuration.

Usage: python scripts/bench_adaptive.py [--res 512 --budget 64]
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--budget", type=int, default=256)
    ap.add_argument("--ref-spp", type=int, default=1024)
    ap.add_argument("--uniform-spps", default="32,64,128")
    ap.add_argument("--tols", default="0.05,0.08,0.12")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--scene", default="cornell")
    args = ap.parse_args()

    import numpy as np

    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions
    from polaris_tpu.render.shade import tonemap_reinhard

    scene = compile_scene(
        read_scene(os.path.join(HERE, "scenes", f"{args.scene}.obj"))
    )
    opt = RenderOptions(
        width=args.res, height=args.res, spp=args.budget,
        num_bounces=5, min_bounces_for_rr=3,
    )
    r = TpuRenderer(scene)

    def tone(accum, spp):
        w = (
            1.0 / spp[..., None].astype(np.float32)
            if isinstance(spp, np.ndarray)
            else 1.0 / spp
        )
        return tonemap_reinhard(np, np.asarray(accum), w, opt.exposure)

    from dataclasses import replace

    ref = tone(
        r.render_accum(replace(opt, spp=args.ref_spp)), args.ref_spp
    )

    # the uniform time-vs-MSE frontier: what fixed spp buys
    results = []
    uni = []
    for spp in (int(x) for x in args.uniform_spps.split(",")):
        o = replace(opt, spp=spp)
        r.render_accum(o)
        t_u = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            accum_u = r.render_accum(o)
            t_u = min(t_u, time.perf_counter() - t0)
        mse_u = float(np.mean((tone(accum_u, spp) - ref) ** 2))
        uni.append((spp, t_u, mse_u))
        results.append({
            "metric": f"uniform_{args.scene}{args.res}_{spp}spp",
            "seconds": round(t_u, 3), "mse_vs_ref": mse_u, "mean_spp": spp,
        })
        print(json.dumps(results[-1]))

    def uniform_time_at(mse):
        """Interpolate the uniform frontier: seconds needed for this MSE
        (MSE ~ a/spp and time ~ b*spp => t_uniform(mse) ~ a*b/mse)."""
        best = None
        for (s1, t1, m1), (s2, t2, m2) in zip(uni, uni[1:]):
            if m2 <= mse <= m1:
                import math

                f = (math.log(m1) - math.log(mse)) / (
                    math.log(m1) - math.log(m2)
                )
                return t1 * (t2 / t1) ** f
        (s1, t1, m1) = uni[-1]
        return t1 * m1 / mse  # extrapolate 1/mse scaling

    for tol in (float(x) for x in args.tols.split(",")):
        accum_a, spp_map = r.render_adaptive(opt, tol=tol, chunk=args.chunk)
        t_ad = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            accum_a, spp_map = r.render_adaptive(opt, tol=tol, chunk=args.chunk)
            t_ad = min(t_ad, time.perf_counter() - t0)
        mse_a = float(np.mean((tone(accum_a, spp_map) - ref) ** 2))
        t_match = uniform_time_at(mse_a)
        results.append({
            "metric": f"adaptive_tol{tol}_budget{args.budget}",
            "seconds": round(t_ad, 3),
            "mse_vs_ref": mse_a,
            "mean_spp": round(float(spp_map.mean()), 1),
            "min_spp": int(spp_map.min()),
            "max_spp": int(spp_map.max()),
            "uniform_seconds_at_this_mse": round(t_match, 3),
            "speedup_vs_uniform_frontier": round(t_match / t_ad, 2),
        })
        print(json.dumps(results[-1]))


if __name__ == "__main__":
    main()
