"""Big-scene benchmark: procedural terrain (320k and 819k triangles).

Measures the traversal on scenes whose BVH is far larger than the caches,
end to end, in auto mode. Prints one JSON line per config.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def main():
    import numpy as np

    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.procedural import make_terrain_scene
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions
    from polaris_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    results = []
    for grid, label in ((400, "terrain320k"), (640, "terrain819k")):
        t0 = time.time()
        scene = compile_scene(make_terrain_scene(grid=grid))
        print(
            f"# {label}: {int(scene.tri_v0.shape[0])} tris, "
            f"{int(scene.bvh_ldata.shape[0])} nodes, "
            f"compile {time.time()-t0:.1f}s",
            file=sys.stderr,
        )
        res, spp = 512, 4
        opt = RenderOptions(
            width=res, height=res, spp=spp, num_bounces=3, min_bounces_for_rr=4
        )
        r = TpuRenderer(scene, mode="auto")
        t0 = time.time()
        img = r.render_u8(opt)  # warmup/compile
        print(f"# {label} compile+first: {time.time()-t0:.1f}s", file=sys.stderr)
        assert np.asarray(img).mean() > 1.0  # nonblack
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            r.render_u8(opt)
            best = min(best, time.perf_counter() - t0)
        rays = res * res * spp * opt.num_bounces * 2
        results.append(
            {
                "metric": f"{label}_{res}x{res}_{spp}spp_Mrays_per_s",
                "value": round(rays / best / 1e6, 2),
                "unit": "Mrays/s",
                "frame_s": round(best, 3),
            }
        )
        print(json.dumps(results[-1]))


if __name__ == "__main__":
    main()
