"""Micro-profile of shade() internals on the GPU.

Times isolated sub-stages (surface reconstruction, material select, bxdf
sample, NEE emissive sample+pdf+eval, RNG draws) on realistic bounce-1
hit data. Each stage repeats K times inside one jit (data-dependent
perturbation prevents CSE) so the dispatch cost amortizes away.
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

from polaris_tpu.asset.camera import Camera
from polaris_tpu.asset.compiler.compiler import compile_scene
from polaris_tpu.asset.wavefront import read_scene
from polaris_tpu.ops import rng
from polaris_tpu.ops import vec as V
from polaris_tpu.ops.bxdf import bxdf_eval, bxdf_pdf, bxdf_sample
from polaris_tpu.ops.emissive import emissive_pdf, emissive_sample, emissive_select
from polaris_tpu.ops.material import select_material
from polaris_tpu.render.integrator import TpuRenderer, blocked_pixel_order
from polaris_tpu.render.raygen import gen_rays
from polaris_tpu.render.shade import shade


def rep_time(fn, args, K=16, reps=5):
    """fn(s, *args) -> array; repeated K times with carry-perturbation.

    The stage is wrapped in its own inner jax.jit: the resulting pjit call
    inside the scan body keeps XLA from hoisting loop-invariant subgraphs
    out of the loop (otherwise stages whose inputs the perturbation doesn't
    reach get measured as ~0)."""
    inner = jax.jit(fn)

    def run(*a):
        def body(c, _):
            s, acc = c
            out = inner(s, *a)
            return (jnp.sum(out) * 0.0, acc + jnp.sum(out)), None

        (s, acc), _ = jax.lax.scan(
            body, (jnp.float32(0.0), jnp.float32(0.0)), None, length=K
        )
        return acc

    jfn = jax.jit(run)
    out = jfn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(jfn(*args))
        best = min(best, time.perf_counter() - t0)
    return best / K


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--scene", default=os.path.join(HERE, "scenes", "sphere.obj"))
    args = ap.parse_args()

    scene = compile_scene(read_scene(args.scene))
    r = TpuRenderer(scene, mode="auto")
    S = {**r.geom, **r.params}
    W = H = args.res
    n = W * H
    cam = Camera.from_scene(scene, W, H)
    xs, ys, pix, _ = blocked_pixel_order(W, H)
    xs, ys, pix = jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(pix)
    seed = jnp.uint32(7)
    print("statics:", S["_stx"])

    # one real bounce to get realistic hit data
    U0 = rng.make_uniform(rng.jnp_uniform, seed, pix, jnp.int32(0), 0)
    ray_o, ray_d = gen_rays(
        jnp, jnp.asarray(cam.frustum), jnp.asarray(cam.position), W, H, xs, ys, U0
    )
    maxt = jnp.full(n, V.FLT_MAX, jnp.float32)
    alive = jnp.ones(n, bool)
    hit = r.closest(S, ray_o, ray_d, maxt, alive)
    hit = jax.tree.map(jax.block_until_ready, hit)
    t = jnp.where(hit.mask, hit.t, 0.0)
    tp = jnp.ones((n, 3), jnp.float32)
    fl = jnp.zeros(n, jnp.uint32)

    U = rng.make_uniform(rng.jnp_uniform, seed, pix, jnp.int32(0), jnp.uint32(1))
    in_dir = -ray_d
    point = ray_o + t[..., None] * ray_d

    rows = []

    # --- RNG draw cost (6 streams)
    def rng_stage(s, pix_):
        Ux = rng.make_uniform(rng.jnp_uniform, seed + s.astype(jnp.uint32) * 0,
                              pix_, jnp.int32(0), jnp.uint32(1))
        return sum(Ux(k) for k in range(6))

    rows.append(("6x RNG draws", rep_time(rng_stage, (pix,))))

    # --- surface reconstruction (normals/uv interpolation + gathers)
    def surf_stage(s, o, d, tt, tri, iu, iv, inst):
        w = 1.0 - iu - iv
        tn = S["tri_normals"][tri]
        n_obj = (
            w[..., None] * tn[..., 0, :]
            + iu[..., None] * tn[..., 1, :]
            + iv[..., None] * tn[..., 2, :]
        )
        w2o = V.take_small(jnp, S["inst_w2o"], inst)
        normal = V.normalize3(jnp, V.transform_normal(jnp, w2o, n_obj))
        root = S["tri_material"][tri] + s.astype(jnp.int32) * 0
        return V.dot3(jnp, normal, normal) + root.astype(jnp.float32)

    rows.append(
        ("surface recon", rep_time(surf_stage, (ray_o, ray_d, t, hit.tri, hit.u, hit.v, hit.inst)))
    )

    # shared shading frame for the stages below
    w = 1.0 - hit.u - hit.v
    tn = S["tri_normals"][hit.tri]
    n_obj = (
        w[..., None] * tn[..., 0, :]
        + hit.u[..., None] * tn[..., 1, :]
        + hit.v[..., None] * tn[..., 2, :]
    )
    w2o = V.take_small(jnp, S["inst_w2o"], hit.inst)
    normal = V.normalize3(jnp, V.transform_normal(jnp, w2o, n_obj))
    normal = jax.block_until_ready(normal)
    root = S["tri_material"][hit.tri]
    uv = jnp.zeros((n, 2), jnp.float32)

    def mat_stage(s, root_, normal_, uv_):
        mat, nrm, tint, fl2 = select_material(
            jnp, S, U, root_, normal_ + s, uv_, fl, max_depth=r.material_depth
        )
        return mat["reflectance"] + nrm + tint

    rows.append(("select_material", rep_time(mat_stage, (root, normal, uv))))

    mat, normal2, tint, _ = select_material(
        jnp, S, U, root, normal, uv, fl, max_depth=r.material_depth
    )
    mat = {k: jax.block_until_ready(v) for k, v in mat.items()}

    def bxdf_stage(s, normal_, in_dir_):
        o, p, v = bxdf_sample(jnp, S, mat, normal_ + s, uv, in_dir_, U(1), U(2))
        return o + v + p[..., None]

    rows.append(("bxdf_sample", rep_time(bxdf_stage, (normal2, in_dir))))

    b_out, b_pdf, b_val = bxdf_sample(jnp, S, mat, normal2, uv, in_dir, U(1), U(2))
    b_out = jax.block_until_ready(b_out)
    num_e = r.num_emissives

    def nee_stage(s, point_, normal_):
        l_idx, sel_pdf = emissive_select(jnp, num_e, U(3))
        e_val, e_dir, e_pdf, e_dist = emissive_sample(
            jnp, S, point_ + s, normal_, l_idx, U(4), U(5)
        )
        return e_val + e_dir + (e_pdf + e_dist)[..., None]

    rows.append(("emissive_sample", rep_time(nee_stage, (point, normal2))))

    l_idx, _ = emissive_select(jnp, num_e, U(3))

    def epdf_stage(s, point_, normal_):
        return emissive_pdf(jnp, S, point_ + s, normal_, l_idx, b_out)

    rows.append(("emissive_pdf", rep_time(epdf_stage, (point, normal2))))

    def beval_stage(s, normal_, in_dir_):
        return bxdf_eval(jnp, S, mat, normal_ + s, uv, in_dir_, b_out)

    rows.append(("bxdf_eval", rep_time(beval_stage, (normal2, in_dir))))

    def bpdf_stage(s, normal_, in_dir_):
        return bxdf_pdf(jnp, S, mat, normal_ + s, uv, in_dir_, b_out)

    rows.append(("bxdf_pdf", rep_time(bpdf_stage, (normal2, in_dir))))

    # --- full shade for reference
    def full_stage(s, o, d, tt):
        out = shade(
            jnp, S, U,
            bounce=1, min_bounces_for_rr=3, num_emissives=num_e,
            material_depth=r.material_depth,
            ray_o=o + s, ray_d=d, t=tt, inst=hit.inst, tri=hit.tri,
            bary_u=hit.u, bary_v=hit.v, hit_mask=hit.mask,
            throughput=tp, flags=fl,
        )
        return out["throughput"] + out["occl_value"] + out["emit_add"]

    rows.append(("FULL shade", rep_time(full_stage, (ray_o, ray_d, t))))

    print(f"\n== shade micro-profile, {W}x{H} ==")
    for name, sec in rows:
        print(f"{name:20s} {sec * 1e3:8.2f} ms")


if __name__ == "__main__":
    main()
