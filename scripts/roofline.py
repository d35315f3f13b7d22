"""Hardware-free traversal work counts for a packet of rays.

Counts, per traversal pass on realistic ray distributions, the work of a
shared-stack packet traversal over one tile of rays: inner-node visits,
leaf visits and triangles tested — via a NumPy replica of the vote
traversal (same near-first ordering and best-t pruning). With
``--tile-rays 1`` a packet is one ray, which gives the per-ray work of the
one-ray-per-lane GPU kernel.

Usage: python scripts/roofline.py [--res 512] [--out counts.json] (CPU only)
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def traverse_tile_counts(scene, o, d, maxt, act, tfar_cull=False):
    """NumPy replica of a shared-stack packet traversal for ONE tile.
    Returns (inner_visits, leaf_visits, leaf_tris_tested).

    ``tfar_cull`` simulates t-far stack culling (round-3 structural
    candidate): each pushed far node carries its tile-min entry distance;
    at pop, the subtree is skipped outright when that distance can no longer
    beat the WORST live best-t in the tile (a scalar-vs-scalar compare in
    a kernel)."""
    ld = scene.bvh_ldata.astype(np.int64)
    rd = scene.bvh_rdata.astype(np.int64)
    bmin = scene.bvh_min
    bmax = scene.bvh_max
    v0a = scene.tri_v0
    e1a = scene.tri_e1
    e2a = scene.tri_e2
    w2o = scene.inst_w2o
    roots = scene.inst_bvh_root.astype(np.int64)

    inner = leaves = tris_tested = 0
    best = np.where(act, maxt, 0.0).astype(np.float64)
    cur_o = o.astype(np.float64).copy()
    cur_d = d.astype(np.float64).copy()
    stack = []
    node = 0
    msbi = -1
    if not act.any():
        return 0, 0, 0

    def slab(ci):
        inv = 1.0 / np.where(np.abs(cur_d) < 1e-30,
                             np.where(cur_d < 0, -1e-30, 1e-30), cur_d)
        t0 = (bmin[ci] - cur_o) * inv
        t1 = (bmax[ci] - cur_o) * inv
        tn = np.minimum(t0, t1).max(axis=1)
        tf = np.maximum(t0, t1).min(axis=1)
        hit = act & ~((tf < 0) | (tn > tf) | (tn >= best))
        return np.where(hit, tn, np.inf)

    while True:
        l, r = ld[node], rd[node]
        if l <= 0 and r == 0:  # top leaf -> enter instance BLAS
            inst = -l
            m = w2o[inst, :3, :]
            cur_o = cur_o @ m[:, :3].T + m[:, 3]
            cur_d = cur_d @ m[:, :3].T
            msbi = len(stack)
            node = roots[inst]
            continue
        if l <= 0:  # bottom leaf
            leaves += 1
            first, count = -l, r
            tris_tested += int(count)
            idx = np.arange(first, first + count)
            v0 = v0a[idx]
            e1 = e1a[idx]
            e2 = e2a[idx]
            pv = np.cross(cur_d[:, None, :], e2[None])
            det = np.einsum("tk,ntk->nt", e1, pv)
            okd = np.abs(det) >= 1e-5
            invd = 1.0 / np.where(okd, det, 1.0)
            tv = cur_o[:, None, :] - v0[None]
            u = np.einsum("ntk,ntk->nt", tv, pv) * invd
            qv = np.cross(tv, e1[None])
            v = np.einsum("nk,ntk->nt", cur_d, qv) * invd
            t = np.einsum("tk,ntk->nt", e2, qv) * invd
            ok = okd & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
            ok &= (t > 1e-5) & (t < best[:, None]) & act[:, None]
            best = np.where(ok.any(1), np.minimum(best, np.where(ok, t, np.inf).min(1)), best)
        else:
            inner += 1
            lmin = slab(l)
            rmin = slab(r)
            wl = np.isfinite(lmin).any()
            wr = np.isfinite(rmin).any()
            if wl and wr:
                if lmin.min() <= rmin.min():
                    near, far, fmin = l, r, rmin.min()
                else:
                    near, far, fmin = r, l, lmin.min()
                stack.append((far, fmin))
                node = near
                continue
            if wl or wr:
                node = l if wl else r
                continue
        # pop
        while True:
            if len(stack) == msbi:
                # leaving the BLAS: restore world rays (recompute from args)
                cur_o = o.astype(np.float64).copy()
                cur_d = d.astype(np.float64).copy()
                msbi = -1
            if not stack:
                return inner, leaves, tris_tested
            node, fmin = stack.pop()
            if tfar_cull:
                # the t parameter is frame-invariant (instance transforms
                # scale the direction without renormalizing), so entry
                # distances compare validly across TLAS/BLAS frames
                worst = best[act].max() if act.any() else 0.0
                if fmin >= worst:
                    continue  # whole subtree culled
            break


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--scene", default=os.path.join(HERE, "scenes", "sphere.obj"),
                    help="obj path, or 'terrain:<grid>' for the procedural "
                         "big-scene fixtures (terrain:640 = 819k tris)")
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--tile-rays", type=int, default=1024,
                    help="rays per traversal packet (a square): 1024 = "
                         "32x32 pixel blocks, 1 = one ray per lane. The "
                         "replay uses the matching blocked pixel order so a "
                         "packet covers a compact screen block")
    ap.add_argument("--out", default=None, help="also write the counts here")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from polaris_tpu.asset.camera import Camera
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene
    from polaris_tpu.ops import rng
    from polaris_tpu.ops import vec as V
    from polaris_tpu.render.integrator import TpuRenderer, blocked_pixel_order
    from polaris_tpu.render.raygen import gen_rays
    from polaris_tpu.render.shade import shade

    if args.scene.startswith("terrain:"):
        from polaris_tpu.asset.procedural import make_terrain_scene

        scene = compile_scene(make_terrain_scene(grid=int(args.scene[8:])))
    else:
        scene = compile_scene(read_scene(args.scene))
    W = H = args.res
    n = W * H
    r = TpuRenderer(scene, mode="bvh")
    S = {**r.geom, **r.params}
    cam = Camera.from_scene(scene, W, H)
    block = int(round(args.tile_rays ** 0.5))
    assert block * block == args.tile_rays, "--tile-rays must be a square"
    xs, ys, pix, _ = blocked_pixel_order(W, H, block=block)
    xsj, ysj, pixj = jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(pix)
    seed = jnp.uint32(7)

    U0 = rng.make_uniform(rng.jnp_uniform, seed, pixj, jnp.int32(0), 0)
    ray_o, ray_d = gen_rays(
        jnp, jnp.asarray(cam.frustum), jnp.asarray(cam.position), W, H,
        xsj, ysj, U0,
    )
    maxt = np.full(n, V.FLT_MAX, np.float32)
    alive = np.ones(n, bool)
    throughput = jnp.ones((n, 3), jnp.float32)
    flags = jnp.zeros(n, jnp.uint32)

    TILE_RAYS = args.tile_rays
    out = {"tile_rays": TILE_RAYS, "scene": args.scene}
    state = (ray_o, ray_d, throughput, flags, jnp.asarray(alive))
    for b in range(args.bounces):
        o, d, tp, fl, act = state
        o_np, d_np, act_np = map(np.asarray, (o, d, act))
        tot = np.zeros(3, np.int64)
        ntiles = n // TILE_RAYS
        for k in range(ntiles):
            sl = slice(k * TILE_RAYS, (k + 1) * TILE_RAYS)
            c = traverse_tile_counts(
                scene, o_np[sl], d_np[sl], maxt[sl], act_np[sl]
            )
            tot += np.asarray(c, np.int64)
        inner, leaf, tris = map(int, tot)
        out[f"bounce{b}"] = {
            "occupancy": float(act_np.mean()),
            "tiles": ntiles,
            "inner_visits": inner,
            "leaf_visits": leaf,
            "tris_tested": tris,
            "per_tile": {
                "inner": round(inner / ntiles, 1),
                "leaf": round(leaf / ntiles, 1),
            },
        }
        print(json.dumps({f"bounce{b}": out[f"bounce{b}"]}))
        # advance to the next bounce's ray distribution
        hit = r.closest(S, o, d, jnp.asarray(maxt), act)
        t = jnp.where(hit.mask, hit.t, 0.0)
        res = shade(
            jnp, S,
            rng.make_uniform(rng.jnp_uniform, seed, pixj, jnp.int32(0), b),
            bounce=b, min_bounces_for_rr=3, num_emissives=r.num_emissives,
            material_depth=r.material_depth, ray_o=o, ray_d=d, t=t,
            inst=hit.inst, tri=hit.tri, bary_u=hit.u, bary_v=hit.v,
            hit_mask=hit.mask, throughput=tp, flags=fl,
        )
        state = (res["next_o"], res["next_d"], res["throughput"],
                 res["flags"], res["next_mask"])

    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
