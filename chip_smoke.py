#!/usr/bin/env python3
"""Smoke test of the path tracer on one GPU: the quickest proof that the
system starts and renders correctly on the card.

    python chip_smoke.py          # one GPU: device, kernel, frame, oracle, train
    python chip_smoke.py --four   # four GPUs: the mesh phase only

Phases (one process, in order):
  1. device  — the platform is "gpu"; prints the device kind and count and
               the card's name and power limit from nvidia-smi.
  2. kernel  — the Pallas traversal kernel, compiled for the card, against
               the XLA per-lane reference (mode "bvh") on 2^20 rays per
               scene (primary rays and one cosine-sampled bounce; sphere,
               cornell, instanced, terrain819k): same (inst, tri) except on
               near-ties, t within 1e-5 relative, u/v within 1e-5, equal
               any-hit masks except at maxt. Also checks that the render
               program holds no matrix product (no TF32 path).
  3. frame   — `polaris-tpu render frame` through cli.main for the five
               BASELINE scenes at 1024^2, 16 spp, 5 bounces, RR after 3:
               the PNG exists, is not black, and at most 0.1% of its pixels
               differ by more than 1/255 from the bvh-mode frame. Prints
               compile seconds, frame ms and Mrays/s.
  4. oracle  — cornell at 64^2 x 2 spp against the NumPy oracle (cpu_ref)
               under tests/test_parity.py's tolerance.
  5. train   — three Trainer steps on a textured scene at 256^2: the loss
               is finite and goes down.

With --four: a (2, 2) tile x sample mesh render of the 1024^2 x 16 spp
sphere frame against the one-card render (a tile-only (4, 1) mesh within
1e-6 relative — on the GPU XLA's fusion of the sharded program moves last
bits, so it is not bit for bit — the sample psum within 1e-5 relative),
and one distributed train step.

Any failure exits non-zero. On success the last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
PNGs go to out/smoke/ in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "out", "smoke")
SCENES = ("sphere", "cornell", "mitsuba", "instanced", "dispersive")
KERNEL_SCENES = ("sphere", "cornell", "instanced", "terrain819k")
FRAME = dict(width=1024, height=1024, spp=16, num_bounces=5, min_bounces_for_rr=3)
RAY_EDGE = 1024  # kernel phase: RAY_EDGE^2 rays per pass
TERRAIN_GRID = 640  # 819k triangles


def log(msg: str) -> None:
    print(msg, flush=True)


def _scene(name: str):
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene

    if name == "terrain819k":
        from polaris_tpu.asset.procedural import make_terrain_scene

        return compile_scene(make_terrain_scene(grid=TERRAIN_GRID))
    return compile_scene(read_scene(os.path.join(HERE, "scenes", f"{name}.obj")))


# ------------------------------------------------------------------ device
def phase_device():
    import jax

    devs = jax.devices()
    log(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    for line in smi.stdout.strip().splitlines():
        log(line.strip())  # name, power limit: exactly as nvidia-smi says
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")


# ------------------------------------------------------------------ kernel
def _probe_rays(scene, S, bvh_closest):
    """2^20 primary rays of a 1024^2 frame, then one cosine-sampled bounce
    from their hits (inactive where the primary ray missed)."""
    import jax.numpy as jnp
    import numpy as np

    from polaris_tpu.asset.camera import Camera
    from polaris_tpu.ops import rng
    from polaris_tpu.render.raygen import gen_rays

    W = H = RAY_EDGE
    cam = Camera.from_scene(scene, W, H)
    ys, xs = np.divmod(np.arange(W * H, dtype=np.int64), W)
    pix = jnp.arange(W * H, dtype=jnp.uint32)
    U = rng.make_uniform(rng.jnp_uniform, jnp.uint32(3), pix, jnp.int32(0), 0)
    o, d = gen_rays(jnp, jnp.asarray(cam.frustum), jnp.asarray(cam.position),
                    W, H, jnp.asarray(xs), jnp.asarray(ys), U)
    maxt = jnp.full(W * H, 3.0e38, jnp.float32)
    act = jnp.ones(W * H, bool)
    hit = bvh_closest(S, o, d, maxt, act)
    # world-space geometric normal of the hit triangle, facing the ray
    o_, d_, t = map(np.asarray, (o, d, hit.t))
    tri, inst, m = np.asarray(hit.tri), np.asarray(hit.inst), np.asarray(hit.mask)
    n_obj = np.cross(scene.tri_e1[tri], scene.tri_e2[tri])
    w2o = scene.inst_w2o[inst, :3, :3]
    n = np.einsum("nji,nj->ni", w2o, n_obj)  # inverse-transpose of o2w
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    n = np.where((n * d_).sum(1, keepdims=True) > 0, -n, n)
    r = np.random.default_rng(0)
    u1, u2 = r.uniform(size=(2, W * H))
    rad, phi = np.sqrt(u1), 2 * np.pi * u2
    a = np.where(np.abs(n[:, :1]) > 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
    tx = np.cross(n, a)
    tx /= np.linalg.norm(tx, axis=1, keepdims=True)
    ty = np.cross(n, tx)
    bd = (tx * (rad * np.cos(phi))[:, None] + ty * (rad * np.sin(phi))[:, None]
          + n * np.sqrt(np.maximum(0.0, 1 - u1))[:, None])
    p = o_ + d_ * t[:, None] + n * 1e-4 * np.maximum(1.0, np.abs(t))[:, None]
    bounce = (jnp.asarray(p, jnp.float32), jnp.asarray(bd, jnp.float32),
              maxt, jnp.asarray(m))
    return (o, d, maxt, act), bounce


def _compare_closest(ref, got, label):
    import numpy as np

    rm, gm = np.asarray(ref.mask), np.asarray(got.mask)
    rt, gt = np.asarray(ref.t, np.float64), np.asarray(got.t, np.float64)
    same = (np.asarray(ref.inst) == np.asarray(got.inst)) & (
        np.asarray(ref.tri) == np.asarray(got.tri)
    )
    both = rm & gm
    # a different triangle is allowed only where the two nearest hits lie
    # within 1e-4 t of each other (the other is then a near-tie)
    differ = both & ~same
    tie = differ & (np.abs(gt - rt) <= 1e-4 * np.abs(rt))
    bad_tri = int((differ & ~tie).sum())
    bad_mask = int((rm != gm).sum())
    ok = both & same
    dt = np.abs(gt - rt)[ok] / np.maximum(np.abs(rt[ok]), 1e-30)
    du = np.abs(np.asarray(ref.u) - np.asarray(got.u))[ok]
    dv = np.abs(np.asarray(ref.v) - np.asarray(got.v))[ok]
    bad_t = int((dt > 1e-5).sum())
    bad_uv = int(((du > 1e-5) | (dv > 1e-5)).sum())
    log(f"  {label}: rays={rm.size} hits={int(rm.sum())} near-ties={int(tie.sum())} "
        f"tri-mismatch={bad_tri} mask-mismatch={bad_mask} t>1e-5={bad_t} "
        f"uv>1e-5={bad_uv} max_rel_dt={dt.max(initial=0):.3g}")
    if bad_tri or bad_mask or bad_t or bad_uv:
        raise AssertionError(f"{label}: kernel disagrees with the reference")


def _compare_any(ref_mask, got_mask, t_closest, maxt, label):
    import numpy as np

    rm, gm = np.asarray(ref_mask), np.asarray(got_mask)
    differ = rm != gm
    # allowed only where the occluder sits within 1e-5 maxt of maxt
    edge = differ & (np.abs(np.asarray(t_closest) - np.asarray(maxt))
                     <= 1e-5 * np.asarray(maxt))
    bad = int((differ & ~edge).sum())
    log(f"  {label}: rays={rm.size} occluded={int(rm.sum())} "
        f"at-maxt={int(edge.sum())} mismatch={bad}")
    if bad:
        raise AssertionError(f"{label}: any-hit masks disagree")


def phase_kernel():
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from polaris_tpu.ops import intersect_pallas as K
    from polaris_tpu.ops.intersect import intersect_bvh

    bvh_c = jax.jit(functools.partial(intersect_bvh, any_hit=False))
    bvh_a = jax.jit(functools.partial(intersect_bvh, any_hit=True))
    ker_c = jax.jit(functools.partial(K.intersect_pallas, any_hit=False))
    ker_a = jax.jit(functools.partial(K.intersect_pallas, any_hit=True))
    for name in KERNEL_SCENES:
        t0 = time.perf_counter()
        scene = _scene(name)
        geom, _ = scene.split_params()
        S = {k: jnp.asarray(v) for k, v in geom.items() if not k.startswith("_")}
        P = {k: jnp.asarray(v) for k, v in K.pack_scene(scene).items()}
        log(f"kernel {name}: {scene.tri_v0.shape[0]} tris, "
            f"{scene.bvh_ldata.shape[0]} nodes (build {time.perf_counter()-t0:.1f} s)")
        primary, bounce = _probe_rays(scene, S, bvh_c)
        for label, rays in (("primary", primary), ("bounce", bounce)):
            ref = bvh_c(S, *rays)
            got = ker_c(P, *rays)
            _compare_closest(ref, got, f"{label} closest")
            # shadow-like queries: maxt spread around the closest hit
            r = np.random.default_rng(1)
            scale = r.uniform(0.5, 1.5, rays[2].shape[0]).astype(np.float32)
            maxt = jnp.where(ref.mask, ref.t * scale, 3.0e38)
            q = (rays[0], rays[1], maxt, rays[3])
            _compare_any(bvh_a(S, *q).mask, ker_a(P, *q).mask, ref.t, maxt,
                         f"{label} any-hit")
        t_ker = _time(lambda: ker_c(P, *bounce))
        t_ref = _time(lambda: bvh_c(S, *bounce))
        log(f"  bounce closest-hit pass: pallas {t_ker*1e3:.3f} ms, "
            f"bvh {t_ref*1e3:.3f} ms")


def _time(fn, reps=3):
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def _assert_no_matmul(renderer, opt):
    """The render program's K=3 math is explicit multiply-add; a dot or a
    cuBLAS call would run f32 as TF32 on this card."""
    from dataclasses import replace

    import jax.numpy as jnp

    from polaris_tpu.asset.camera import Camera

    cam = Camera.from_scene(renderer.scene, opt.width, opt.height)
    chunk = min(renderer.spp_per_launch, opt.spp)
    fn = renderer._get_chunk_carry_fn(replace(opt, spp=chunk))
    hlo = fn.lower(
        renderer.geom, renderer.params, jnp.asarray(cam.frustum),
        jnp.asarray(cam.position), jnp.uint32(0), jnp.int32(0),
        jnp.zeros((opt.width * opt.height, 3), jnp.float32),
    ).compile().as_text()
    found = [w for w in (" dot(", "cublas", "gemm") if w in hlo]
    if found:
        raise AssertionError(f"matrix product in the render program: {found}")


# ------------------------------------------------------------------- frame
def phase_frame():
    import numpy as np

    from polaris_tpu import cli
    from polaris_tpu.asset.png import read_png
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions

    os.makedirs(OUT, exist_ok=True)
    opt = RenderOptions(**FRAME)
    rays = opt.width * opt.height * opt.spp * opt.num_bounces * 2
    argv = ["--width", str(opt.width), "--height", str(opt.height),
            "--spp", str(opt.spp), "--num-bounces", str(opt.num_bounces),
            "--rr-bounces", str(opt.min_bounces_for_rr)]
    for name in SCENES:
        scene = _scene(name)
        r = TpuRenderer(scene, mode="auto")
        t0 = time.perf_counter()
        r.render_u8(opt)
        first = time.perf_counter() - t0
        frame = _time(lambda: r.render_u8(opt), reps=2)
        log(f"frame {name}: compile {first - frame:.1f} s, frame "
            f"{frame*1e3:.1f} ms, {rays / frame / 1e6:.1f} Mrays/s")
        _assert_no_matmul(r, opt)
        path = os.path.join(OUT, f"{name}.png")
        ref_path = os.path.join(OUT, f"{name}_bvh.png")
        scene_path = os.path.join(HERE, "scenes", f"{name}.obj")
        for p, extra in ((path, []), (ref_path, ["--mode", "bvh"])):
            if os.path.exists(p):
                os.remove(p)
            rc = cli.main(["render", "frame", scene_path, *argv, *extra,
                           "--out", p])
            if rc != 0 or not os.path.exists(p):
                raise AssertionError(f"{name}: CLI wrote no frame ({rc})")
        img, ref = read_png(path).astype(int), read_png(ref_path).astype(int)
        if img.shape != (opt.height, opt.width, 3) or img.mean() < 1.0:
            raise AssertionError(f"{name}: frame is black or misshapen")
        frac = float((np.abs(img - ref).max(-1) > 1).mean())
        log(f"  {name}: mean {img.mean():.2f}, pixels off bvh by >1/255: "
            f"{frac:.5f}")
        if frac > 1e-3:
            raise AssertionError(f"{name}: frame differs from the bvh frame")


# ------------------------------------------------------------------ oracle
def phase_oracle():
    import numpy as np

    from polaris_tpu.cpu_ref.renderer import CpuRenderer
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions

    scene = _scene("cornell")
    opt = RenderOptions(width=64, height=64, spp=2, num_bounces=3,
                        min_bounces_for_rr=4)
    golden = CpuRenderer(scene).render_accum(opt)
    got = np.asarray(TpuRenderer(scene, mode="auto").render_accum(opt))
    err = np.abs(got - golden) - (1e-4 + 1e-3 * np.abs(golden))
    log(f"oracle cornell 64x64x2: max |device - oracle| "
        f"{np.abs(got - golden).max():.3g}, lanes over tolerance "
        f"{int((err > 0).any(-1).sum())}")
    np.testing.assert_allclose(got, golden, atol=1e-4, rtol=1e-3)


# ------------------------------------------------------------------- train
_TEX_MTL = (
    'newmtl tfloor\nmat_expr diffuse(reflectance: "checker.png")\n\n'
    "newmtl rough\nmat_expr roughConductor(specularity: {0.9, 0.8, 0.6},"
    " roughness: 0.3, intIOR: 1.8)\n\n"
    "newmtl lamp\nmat_expr emissive(radiance: {1, 1, 1}, scale: 16)\n\n"
)
_TEX_OBJ = (
    "mtllib t.mtl\n"
    "camera_fov 45\ncamera_eye 0 1.0 2.5\ncamera_look 0 0.5 0\n"
    "camera_up 0 1 0\n"
    "v -2 0 -2\nv -2 0 2\nv 2 0 2\nv 2 0 -2\n"
    "vt 0 0\nvt 0 2\nvt 2 2\nvt 2 0\n"
    "usemtl tfloor\nf 1/1 2/2 3/3 4/4\n"
    "v -1.5 0 -1.8\nv 1.5 0 -1.8\nv 1.5 2 -1.8\nv -1.5 2 -1.8\n"
    "usemtl rough\nf 5 6 7 8\n"
    "v -0.7 2.8 -0.7\nv 0.7 2.8 -0.7\nv 0.7 2.8 0.7\nv -0.7 2.8 0.7\n"
    "usemtl lamp\nf 9 10 11 12\n"
)


def phase_train():
    import shutil

    import numpy as np

    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene
    from polaris_tpu.render.grad import DifferentiableRenderer
    from polaris_tpu.render.options import RenderOptions
    from polaris_tpu.render.shade import tonemap_reinhard
    from polaris_tpu.render.trainer import TrainConfig, Trainer

    d = os.path.join(OUT, "textured")
    os.makedirs(d, exist_ok=True)
    shutil.copy(os.path.join(HERE, "scenes", "checker.png"), d)
    with open(os.path.join(d, "t.mtl"), "w") as f:
        f.write(_TEX_MTL)
    with open(os.path.join(d, "t.obj"), "w") as f:
        f.write(_TEX_OBJ)
    scene = compile_scene(read_scene(os.path.join(d, "t.obj")), float_textures=True)
    opt = RenderOptions(width=256, height=256, spp=4, num_bounces=3,
                        min_bounces_for_rr=3)
    r = DifferentiableRenderer(scene, mode="auto")
    tgt = dict(r.params)
    tgt["tex_data"] = r.params["tex_data"] * 0.5
    accum = np.asarray(r.render_from_params(opt, tgt))
    target = tonemap_reinhard(np, accum + 1e-6, 1.0 / opt.spp, opt.exposure)
    cfg = TrainConfig(learning_rate=4e-2, num_steps=3,
                      trainable=("tex_data", "mat_roughness"),
                      reseed_each_step=False)
    tr = Trainer(scene, opt, cfg, mode="auto")
    t0 = time.perf_counter()
    hist = tr.fit(target)
    log(f"train: losses {[round(float(x), 6) for x in hist]} "
        f"({time.perf_counter() - t0:.1f} s for 3 steps incl. compile)")
    if not np.isfinite(hist).all() or not hist[-1] < hist[0]:
        raise AssertionError(f"loss did not go down: {hist}")


# -------------------------------------------------------------------- mesh
def phase_mesh():
    import jax
    import numpy as np

    from polaris_tpu.parallel.mesh import DistributedRenderer, make_mesh
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, found {len(jax.devices())}")
    scene = _scene("sphere")
    opt = RenderOptions(**FRAME)
    single = TpuRenderer(scene, mode="auto")
    single.spp_per_launch = opt.spp  # one launch: the same sample sum order
    ref = np.asarray(single.render_accum(opt))
    t1 = _time(lambda: single.render_accum(opt), reps=2)
    for tile, sample in ((4, 1), (2, 2)):
        dist = DistributedRenderer(scene, make_mesh(tile, sample), mode="auto")
        got = np.asarray(dist.render_accum(opt))
        tm = _time(lambda: dist.render_accum(opt), reps=2)
        rel = float((np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)).max())
        log(f"mesh {tile}x{sample}: {tm*1e3:.1f} ms vs one card {t1*1e3:.1f} ms "
            f"(speedup {t1 / tm:.2f}), max rel diff {rel:.3g}, values not "
            f"bit-identical {int((got != ref).sum())} of {got.size}")
        # a tile-only mesh runs the same per-pixel arithmetic, but XLA fuses
        # the sharded program differently, so fused multiply-adds can move
        # the last bits (bit-identical on the CPU, tests/test_sharding.py);
        # the sample psum also reassociates the per-sample sums
        np.testing.assert_allclose(got, ref, rtol=1e-6 if sample == 1 else 1e-5,
                                   atol=1e-7)
    small = RenderOptions(width=256, height=256, spp=4, num_bounces=3,
                          min_bounces_for_rr=3)
    dist = DistributedRenderer(scene, make_mesh(2, 2), mode="auto")
    target = np.zeros((small.height, small.width, 3), np.float32)
    loss = dist.train_step(small, target, lr=0.05)
    log(f"mesh 2x2 train step: loss {float(loss):.6f}")
    if not np.isfinite(loss):
        raise AssertionError("distributed train step gave a non-finite loss")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "polaris_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    from polaris_tpu.utils.cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    phases = [("device", phase_device)]
    if args.four:
        phases.append(("mesh", phase_mesh))
    else:
        phases += [("kernel", phase_kernel), ("frame", phase_frame),
                   ("oracle", phase_oracle), ("train", phase_train)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            log(f"phase {name}: FAILED ({time.perf_counter() - t0:.1f} s)")
            failed.append(name)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
