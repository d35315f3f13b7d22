"""Render all five benchmark configs to docs/renders/ (run on the GPU or CPU).

Usage: python scripts/render_showcase.py [--res 256] [--spp 32] [--mode auto]
"""

import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CONFIGS = {
    "sphere": dict(num_bounces=5, min_bounces_for_rr=3),
    "cornell": dict(num_bounces=5, min_bounces_for_rr=3),
    "mitsuba": dict(num_bounces=5, min_bounces_for_rr=3),
    "instanced": dict(num_bounces=4, min_bounces_for_rr=3),
    "dispersive": dict(num_bounces=6, min_bounces_for_rr=3),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--mode", default="auto")
    ap.add_argument("--scenes", nargs="*", default=list(CONFIGS))
    ap.add_argument("--denoise-demo", action="store_true",
                    help="also write cornell_denoise_demo.png: noisy "
                         "low-spp frame | à-trous denoised, side by side")
    args = ap.parse_args()

    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.png import save_image
    from polaris_tpu.asset.wavefront import read_scene
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions

    out_dir = os.path.join(HERE, "docs", "renders")
    os.makedirs(out_dir, exist_ok=True)
    renderers = {}  # reuse compiled scenes/programs across the demo step

    def get_renderer(name):
        if name not in renderers:
            scene = compile_scene(
                read_scene(os.path.join(HERE, "scenes", f"{name}.obj"))
            )
            renderers[name] = TpuRenderer(scene, mode=args.mode)
        return renderers[name]

    for name in args.scenes:
        cfg = CONFIGS[name]
        r = get_renderer(name)
        opt = RenderOptions(width=args.res, height=args.res, spp=args.spp, **cfg)
        t0 = time.perf_counter()
        img = r.render(opt)
        dt = time.perf_counter() - t0
        path = os.path.join(out_dir, f"{name}_{args.res}_{args.spp}spp.png")
        save_image(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
        print(f"{name}: {dt:.1f}s -> {path}", flush=True)

    if args.denoise_demo:
        from polaris_tpu.render.denoise import denoise_accum
        from polaris_tpu.render.shade import tonemap_reinhard

        r = get_renderer("cornell")
        opt = RenderOptions(width=args.res, height=args.res, spp=2,
                            **CONFIGS["cornell"])
        accum = np.asarray(r.render_accum(opt))
        noisy = np.asarray(
            tonemap_reinhard(np, accum, 1.0 / opt.spp, opt.exposure)
        )
        den_accum = denoise_accum(r, opt, accum, opt.spp)
        den = np.asarray(
            tonemap_reinhard(np, den_accum, 1.0 / opt.spp, opt.exposure)
        )
        sep = np.ones((args.res, 4, 3), np.float32)
        demo = np.concatenate([noisy, sep, den], axis=1)
        path = os.path.join(out_dir, "cornell_denoise_demo.png")
        save_image(path, (np.clip(demo, 0, 1) * 255).astype(np.uint8))
        print(f"denoise demo (2 spp | denoised): -> {path}", flush=True)


if __name__ == "__main__":
    main()
