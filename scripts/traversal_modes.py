"""Frame time of each traversal mode, end to end, on the GPU.

Renders full frames (scene -> TpuRenderer -> u8 frame) at the reference's
default size, 1024^2 x 16 spp, 5 bounces, RR after 3, with the Pallas kernel
('pallas') and the two XLA traversals ('bvh', 'packet'). ``auto`` on the GPU
takes the fastest of these (ops/intersect.py: GPU_AUTO_MODE).

Usage: python scripts/traversal_modes.py [--scenes sphere,cornell,terrain819k]
                                         [--modes pallas,bvh,packet]
Prints one JSON line per (scene, mode) naming the device and its power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import replace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _scene(name):
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.procedural import make_terrain_scene
    from polaris_tpu.asset.wavefront import read_scene

    if name.startswith("terrain"):
        grid = {"terrain320k": 400, "terrain819k": 640}[name]
        return compile_scene(make_terrain_scene(grid=grid))
    return compile_scene(read_scene(os.path.join(HERE, "scenes", f"{name}.obj")))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default="sphere,cornell,terrain819k")
    ap.add_argument("--modes", default="pallas,bvh,packet")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed frames per fast mode (slow modes time one)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from polaris_tpu.asset.camera import Camera
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions
    from polaris_tpu.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"traversal_modes.py measures the GPU; found {dev.platform!r}")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    opt = RenderOptions(width=1024, height=1024, spp=16, num_bounces=5,
                        min_bounces_for_rr=3)
    rays = opt.width * opt.height * opt.spp * opt.num_bounces * 2
    for name in args.scenes.split(","):
        scene = _scene(name)
        cam = Camera.from_scene(scene, opt.width, opt.height)
        for mode in args.modes.split(","):
            r = TpuRenderer(scene, mode=mode)
            # compile ahead of time (the persistent cache then serves the
            # timed frames), so slow modes need only one timed frame
            t0 = time.perf_counter()
            chunk = replace(opt, spp=min(r.spp_per_launch, opt.spp))
            r._get_chunk_carry_fn(chunk).lower(
                r.geom, r.params, jnp.asarray(cam.frustum),
                jnp.asarray(cam.position), jnp.uint32(0), jnp.int32(0),
                jnp.zeros((opt.width * opt.height, 3), jnp.float32),
            ).compile()
            r._get_finalize_fn(opt.width, opt.height, "u8")(
                jnp.zeros((opt.width * opt.height, 3), jnp.float32),
                jnp.float32(1.0), jnp.float32(1.0),
            ).block_until_ready()
            compile_s = time.perf_counter() - t0
            times = []
            for i in range(args.reps if mode == "pallas" else 1):
                t0 = time.perf_counter()
                img = r.render_u8(opt)
                times.append(time.perf_counter() - t0)
            best = min(times)
            print(json.dumps({
                "scene": name, "mode": mode, "tris": int(scene.tri_v0.shape[0]),
                "frame_ms": round(best * 1e3, 1),
                "mrays_per_s": round(rays / best / 1e6, 1),
                "compile_s": round(compile_s, 1),
                "frames_timed": len(times),
                "image_mean": round(float(np.asarray(img).mean()), 3),
                "device": {"platform": dev.platform, "kind": dev.device_kind},
                "card": card,
            }), flush=True)


if __name__ == "__main__":
    main()
