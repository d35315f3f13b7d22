"""Inverse-rendering demo on the GPU: recover material colors from a target.

The differentiable capstone (SURVEY.md §7 step 5): darken/tint the Cornell
scene's diffuse reflectances, render a target, then optimize the ORIGINAL
scene's parameters to match it. Writes target/initial/final renders, the
loss curve, and a JSON summary into docs/renders/train_demo/.

Usage: python scripts/demo_train.py [--res 128 --spp 4 --steps 40]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--mode", default="auto")
    args = ap.parse_args()

    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.png import save_image
    from polaris_tpu.asset.wavefront import read_scene
    from polaris_tpu.render.grad import DifferentiableRenderer
    from polaris_tpu.render.options import RenderOptions
    from polaris_tpu.render.shade import tonemap_reinhard
    from polaris_tpu.render.trainer import TrainConfig, Trainer

    out_dir = os.path.join(HERE, "docs", "renders", "train_demo")
    os.makedirs(out_dir, exist_ok=True)
    scene = compile_scene(read_scene(os.path.join(HERE, "scenes", "cornell.obj")))
    opt = RenderOptions(
        width=args.res, height=args.res, spp=args.spp,
        num_bounces=3, min_bounces_for_rr=4,
    )

    def save(name, img01):
        save_image(os.path.join(out_dir, name),
                   (np.clip(img01, 0, 1) * 255).astype(np.uint8))

    # --- target: secretly tinted diffuse reflectances ---
    r = DifferentiableRenderer(scene, mode=args.mode)
    true_params = dict(r.params)
    tint = np.asarray(r.params["mat_reflectance"]).copy()
    tint *= np.array([0.45, 0.8, 0.6], np.float32)  # channel-skewed darkening
    import jax.numpy as jnp

    true_params["mat_reflectance"] = jnp.asarray(tint)
    accum = np.asarray(r.render_from_params(opt, true_params))
    target = tonemap_reinhard(np, accum + 1e-6, 1.0 / opt.spp, opt.exposure)
    save("target.png", target)

    # --- initial render from the untinted scene ---
    accum0 = np.asarray(r.render_from_params(opt, dict(r.params)))
    save("initial.png", tonemap_reinhard(np, accum0 + 1e-6, 1.0 / opt.spp, opt.exposure))

    # common random numbers: the target uses the same seed as the training
    # renders, so the Monte-Carlo noise cancels exactly in the residual and
    # MSE's variance-matching bias disappears (measured: at spp<=4,
    # reseeding diverges 0.005 -> 0.02 while CRN converges 0.005 -> 0.0007)
    cfg = TrainConfig(
        learning_rate=args.lr, num_steps=args.steps, reseed_each_step=False,
    )
    tr = Trainer(scene, opt, cfg, mode=args.mode)
    t0 = time.time()
    history = tr.fit(np.asarray(target))
    wall = time.time() - t0

    accum1 = np.asarray(
        r.render_from_params(opt, {k: v for k, v in tr.renderer.params.items()})
    )
    save("recovered.png", tonemap_reinhard(np, accum1 + 1e-6, 1.0 / opt.spp, opt.exposure))

    got = np.asarray(tr.renderer.params["mat_reflectance"])
    recovered = tonemap_reinhard(np, accum1 + 1e-6, 1.0 / opt.spp, opt.exposure)
    initial = tonemap_reinhard(np, accum0 + 1e-6, 1.0 / opt.spp, opt.exposure)
    summary = {
        "steps": args.steps,
        "wall_s": round(wall, 1),
        "ms_per_step": round(wall * 1e3 / args.steps, 1),
        "loss_first": round(float(history[0]), 6),
        "loss_last": round(float(history[-1]), 6),
        "image_l1_initial": round(float(np.abs(initial - target).mean()), 5),
        "image_l1_recovered": round(float(np.abs(recovered - target).mean()), 5),
        # parameter error only over materials that are actually visible
        # enough to constrain (gradient magnitude above 1% of the max)
        "max_abs_reflectance_error_all": round(float(np.abs(got - tint).max()), 4),
        "loss_curve": [round(float(x), 6) for x in history],
    }
    _, g, _ = tr.renderer.loss_and_grad(opt, np.asarray(target))
    gmag = np.abs(np.asarray(g["mat_reflectance"])).sum(axis=1)
    vis = gmag > 0.01 * gmag.max()
    summary["max_abs_reflectance_error_visible"] = round(
        float(np.abs(got - tint)[vis].max()), 4
    )
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "loss_curve"}))


if __name__ == "__main__":
    main()
