"""A/B: wavefront path regeneration vs the sequential sample loop.

Round-4 VERDICT item 1: the 4x useful-vs-raw ray gap lives in dead lanes
WITHIN live tiles (scattered RR deaths + misses). Path regeneration
restarts a dead lane at its OWN pixel with its next sample index inside
the loop (render_block_regen) — no permutation, no coherence loss.

Run on the GPU: python scripts/bench_regen.py [--res 512]
Prints one JSON line per row.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def best_of(fn, reps=3):
    fn()  # warmup/compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--configs", default="sphere16,cornell64")
    args = ap.parse_args()

    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions

    cases = {
        # scene, spp, spp_per_launch, rr_tile_coherent
        "sphere16": ("sphere.obj", 16, 16, False),
        "cornell64": ("cornell.obj", 64, 8, False),
        # wider launches: regen's straggler tail (a tile stays live until
        # its WORST lane finishes all its samples) amortizes over more
        # samples per while_loop
        "cornell64w": ("cornell.obj", 64, 16, False),
        # tile-coherent RR correlates deaths within a block, collapsing
        # the per-tile max toward the mean path length
        "cornell64rr": ("cornell.obj", 64, 16, True),
    }
    results = {}
    for key in args.configs.split(","):
        obj, spp, per_launch, rr_tc = cases[key]
        scene = compile_scene(read_scene(os.path.join(HERE, "scenes", obj)))
        opt = RenderOptions(
            width=args.res, height=args.res, spp=spp, num_bounces=5,
            min_bounces_for_rr=3, rr_tile_coherent=rr_tc,
        )
        row = {}
        for regen in (False, True):
            r = TpuRenderer(scene, mode="auto", regen=regen)
            r.spp_per_launch = per_launch
            dt = best_of(lambda: r.render_u8(opt), args.reps)
            rays = args.res * args.res * spp * opt.num_bounces * 2
            row["regen" if regen else "seq"] = {
                "seconds": round(dt, 4),
                "mrays_per_s": round(rays / dt / 1e6, 2),
            }
        row["speedup"] = round(
            row["seq"]["seconds"] / row["regen"]["seconds"], 4
        )
        results[key] = row
        print(key, json.dumps(row))


if __name__ == "__main__":
    main()
