"""Ray/scene intersection on the device: two-level BVH traversal + brute mode.

Counterpart of the reference's traversal kernels
(``CL/kernels/intersect.cl``):
  * ``rayIntersectionQuery``  (closest hit, intersect.cl:184-347)
  * ``rayIntersectionTest``   (any hit / occlusion, intersect.cl:26-180)
  * two-level scheme: TLAS leaves load a mesh instance, transform the ray by
    the instance's world->object matrix, and continue into the mesh BLAS;
    on BLAS exit the ray is restored (intersect.cl:74-88,164-169)

The XLA traversal (the plain reference for the GPU kernel in
ops/intersect_pallas.py):

  * All lanes advance together inside one ``lax.while_loop``; each lane keeps
    its own traversal stack in a [N, 32] array (the reference's per-thread
    ``uint nodeStack[32]``). Per-lane control flow becomes a small *phase*
    state machine (NODE / TRI / POP) resolved with vectorized selects —
    leaf triangles are streamed one per iteration instead of an inner loop,
    so every iteration costs the same small number of gathers for all lanes.
  * Near-child-first ordering uses the actual slab distances (the reference's
    non-packet kernels always descend left first; ordering only affects
    speed, not results).
  * For small scenes a ``brute`` mode skips the BVH entirely: a
    ``lax.scan`` over ray chunks tests every instance triangle with dense
    vectorized Möller–Trumbore — dense work with no gathers, for scenes of a
    few thousand triangles and for debugging.

Both modes return identical results (same epsilon semantics,
intersect.cl:90-125) and are cross-checked against the NumPy golden renderer.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import vec as V

STACK_SIZE = 32  # BVH_MAX_STACK_SIZE (intersect.cl:4)

PHASE_NODE = 0
PHASE_TRI = 1
PHASE_POP = 2
PHASE_DONE = 3


class Hit(NamedTuple):
    t: jnp.ndarray
    inst: jnp.ndarray
    tri: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    mask: jnp.ndarray


# ----------------------------------------------------------------- brute mode


def _mt_dense(o, d, maxt, v0, e1, e2):
    """Dense Möller–Trumbore: [C] rays x [T] tris -> per-ray best hit.

    All contractions are explicit multiply+sum: a K=3 einsum/`@` would lower
    to a dot_general whose default f32 precision on the GPU is TF32 — fatally
    imprecise for intersection tests (and matrix units gain nothing at K=3).
    """
    de = d[:, None, :]
    pvec = V.cross3(jnp, de, e2[None, :, :])
    det = V.dot3(jnp, e1[None, :, :], pvec)
    ok = jnp.abs(det) >= V.INTERSECTION_EPSILON
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tvec = o[:, None, :] - v0[None, :, :]
    u = V.dot3(jnp, tvec, pvec) * inv_det
    ok &= (u >= 0.0) & (u <= 1.0)
    qvec = V.cross3(jnp, tvec, e1[None, :, :])
    v = V.dot3(jnp, de, qvec) * inv_det
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = V.dot3(jnp, e2[None, :, :], qvec) * inv_det
    ok &= (t > V.INTERSECTION_EPSILON) & (t < maxt[:, None])
    t = jnp.where(ok, t, jnp.inf)
    best = jnp.argmin(t, axis=1)
    rows = jnp.arange(t.shape[0])
    return t[rows, best], best, u[rows, best], v[rows, best]


def intersect_brute(S, o, d, maxt, active, *, inst_tri_ranges, chunk=8192):
    """Closest-hit over all instances without a BVH.

    ``inst_tri_ranges``: static list of (first_tri, num_tris) per instance
    (recovered from the BLAS at setup). Rays are processed in chunks via
    lax.scan to bound the [C, T] working set in device memory.
    """
    n = o.shape[0]
    pad = (-n) % chunk
    o_p = jnp.pad(o, ((0, pad), (0, 0)))
    d_p = jnp.pad(d, ((0, pad), (0, 0)))
    maxt_p = jnp.pad(maxt, (0, pad))
    act_p = jnp.pad(active, (0, pad))
    num_chunks = o_p.shape[0] // chunk

    def chunk_fn(_, inputs):
        co, cd, cmaxt, cact = inputs
        best_t = jnp.where(cact, cmaxt, 0.0)
        best_tri = jnp.zeros(chunk, jnp.int32)
        best_inst = jnp.zeros(chunk, jnp.int32)
        best_u = jnp.zeros(chunk, jnp.float32)
        best_v = jnp.zeros(chunk, jnp.float32)
        found = jnp.zeros(chunk, bool)
        for ii, (first, count) in enumerate(inst_tri_ranges):
            w2o = S["inst_w2o"][ii]
            oo = V.transform_point(jnp, w2o, co)
            dd = V.transform_dir(jnp, w2o, cd)
            v0 = jax.lax.dynamic_slice_in_dim(S["tri_v0"], first, count)
            e1 = jax.lax.dynamic_slice_in_dim(S["tri_e1"], first, count)
            e2 = jax.lax.dynamic_slice_in_dim(S["tri_e2"], first, count)
            t, rel, u, v = _mt_dense(oo, dd, best_t, v0, e1, e2)
            upd = t < best_t
            best_t = jnp.where(upd, t, best_t)
            best_tri = jnp.where(upd, first + rel.astype(jnp.int32), best_tri)
            best_inst = jnp.where(upd, ii, best_inst)
            best_u = jnp.where(upd, u, best_u)
            best_v = jnp.where(upd, v, best_v)
            found = found | upd
        return None, (best_t, best_inst, best_tri, best_u, best_v, found)

    inputs = tuple(
        x.reshape((num_chunks, chunk) + x.shape[1:])
        for x in (o_p, d_p, maxt_p, act_p)
    )
    _, outs = jax.lax.scan(chunk_fn, None, inputs)
    t, inst, tri, u, v, found = (x.reshape(-1)[:n] for x in outs)
    t = jnp.where(found, t, 0.0)
    return Hit(t, inst, tri, u, v, active & found)


# ------------------------------------------------------------------- bvh mode


def _gather_node(S, idx):
    return (
        S["bvh_min"][idx],
        S["bvh_max"][idx],
        S["bvh_ldata"][idx],
        S["bvh_rdata"][idx],
    )


def _slab_test(o, d, bmin, bmax, best_t):
    """AABB slab test -> entry distance, FLT_MAX on miss
    (intersect.cl:135-155)."""
    inv = 1.0 / jnp.where(jnp.abs(d) < 1e-30, jnp.where(d < 0, -1e-30, 1e-30), d)
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    minmax = jnp.min(tmax, axis=-1)
    maxmin = jnp.max(tmin, axis=-1)
    miss = (minmax < 0.0) | (maxmin > minmax) | (maxmin >= best_t)
    return jnp.where(miss, V.FLT_MAX, maxmin)


def intersect_bvh(S, o, d, maxt, active, *, any_hit: bool):
    """Two-level BVH traversal for all lanes in one lax.while_loop."""
    n = o.shape[0]
    rows = jnp.arange(n)
    f32 = jnp.float32

    state = dict(
        phase=jnp.where(active, PHASE_NODE, PHASE_DONE).astype(jnp.int32),
        node=jnp.zeros(n, jnp.int32),
        stack=jnp.zeros((n, STACK_SIZE), jnp.int32),
        sp=jnp.zeros(n, jnp.int32),
        msbi=jnp.full(n, -1, jnp.int32),
        cur_o=o,
        cur_d=d,
        inst=jnp.zeros(n, jnp.int32),
        cursor=jnp.zeros(n, jnp.int32),
        remaining=jnp.zeros(n, jnp.int32),
        best_t=jnp.where(active, maxt, 0.0).astype(f32),
        best_tri=jnp.zeros(n, jnp.int32),
        best_inst=jnp.zeros(n, jnp.int32),
        best_u=jnp.zeros(n, f32),
        best_v=jnp.zeros(n, f32),
        found=jnp.zeros(n, bool),
    )

    def cond(st):
        return jnp.any(st["phase"] != PHASE_DONE)

    def body(st):
        phase = st["phase"]

        # ---------- TRI phase: stream one triangle (intersect.cl:90-125)
        in_tri = phase == PHASE_TRI
        tri = jnp.clip(st["cursor"], 0, S["tri_v0"].shape[0] - 1)
        v0 = S["tri_v0"][tri]
        e1 = S["tri_e1"][tri]
        e2 = S["tri_e2"][tri]
        co, cd = st["cur_o"], st["cur_d"]
        pvec = V.cross3(jnp, cd, e2)
        det = V.dot3(jnp, e1, pvec)
        ok = jnp.abs(det) >= V.INTERSECTION_EPSILON
        inv_det = 1.0 / jnp.where(ok, det, 1.0)
        tvec = co - v0
        uu = V.dot3(jnp, tvec, pvec) * inv_det
        ok &= (uu >= 0.0) & (uu <= 1.0)
        qvec = V.cross3(jnp, tvec, e1)
        vv = V.dot3(jnp, cd, qvec) * inv_det
        ok &= (vv >= 0.0) & (uu + vv <= 1.0)
        tt = V.dot3(jnp, e2, qvec) * inv_det
        ok &= (tt > V.INTERSECTION_EPSILON) & (tt < st["best_t"])
        tri_hit = in_tri & ok

        best_t = jnp.where(tri_hit, tt, st["best_t"])
        best_tri = jnp.where(tri_hit, tri, st["best_tri"])
        best_inst = jnp.where(tri_hit, st["inst"], st["best_inst"])
        best_u = jnp.where(tri_hit, uu, st["best_u"])
        best_v = jnp.where(tri_hit, vv, st["best_v"])
        found = st["found"] | tri_hit

        cursor = jnp.where(in_tri, st["cursor"] + 1, st["cursor"])
        remaining = jnp.where(in_tri, st["remaining"] - 1, st["remaining"])
        # after the last triangle -> POP; any-hit terminates on first hit
        tri_done = in_tri & (remaining <= 0)
        phase = jnp.where(tri_done, PHASE_POP, phase)
        if any_hit:
            phase = jnp.where(tri_hit, PHASE_DONE, phase)

        # ---------- NODE phase (intersect.cl:71-157)
        in_node = phase == PHASE_NODE
        bmin, bmax, ld, rd = _gather_node(S, st["node"])
        is_leaf = ld <= 0
        is_top_leaf = in_node & is_leaf & (rd == 0)
        is_bot_leaf = in_node & is_leaf & (rd > 0)
        is_inner = in_node & (~is_leaf)

        # top leaf: jump into the instance BLAS with a transformed ray
        inst_id = jnp.clip(-ld, 0, S["inst_w2o"].shape[0] - 1)
        w2o = S["inst_w2o"][inst_id]
        to = V.transform_point(jnp, w2o, co)
        td = V.transform_dir(jnp, w2o, cd)
        cur_o = V.where3(jnp, is_top_leaf, to, co)
        cur_d = V.where3(jnp, is_top_leaf, td, cd)
        inst = jnp.where(is_top_leaf, inst_id, st["inst"])
        msbi = jnp.where(is_top_leaf, st["sp"], st["msbi"])
        node = jnp.where(is_top_leaf, S["inst_bvh_root"][inst_id], st["node"])

        # bottom leaf: arm the triangle streamer
        cursor = jnp.where(is_bot_leaf, -ld, cursor)
        remaining = jnp.where(is_bot_leaf, rd, remaining)
        phase = jnp.where(is_bot_leaf, jnp.where(rd > 0, PHASE_TRI, PHASE_POP), phase)

        # inner: slab-test both children, near first
        lmin, lmax, _, _ = _gather_node(S, jnp.clip(ld, 0, None))
        rmin, rmax, _, _ = _gather_node(S, jnp.clip(rd, 0, None))
        l_dist = _slab_test(cur_o, cur_d, lmin, lmax, best_t)
        r_dist = _slab_test(cur_o, cur_d, rmin, rmax, best_t)
        want_l = l_dist < V.FLT_MAX
        want_r = r_dist < V.FLT_MAX
        both = is_inner & want_l & want_r
        near_is_l = l_dist <= r_dist
        near = jnp.where(near_is_l, ld, rd)
        far = jnp.where(near_is_l, rd, ld)
        one = is_inner & (want_l ^ want_r)
        none = is_inner & (~want_l) & (~want_r)

        # push far child for lanes taking both
        sp_c = jnp.clip(st["sp"], 0, STACK_SIZE - 1)
        old = st["stack"][rows, sp_c]
        stack = st["stack"].at[rows, sp_c].set(jnp.where(both, far, old))
        sp = jnp.where(both, st["sp"] + 1, st["sp"])
        node = jnp.where(both, near, node)
        node = jnp.where(one, jnp.where(want_l, ld, rd), node)
        phase = jnp.where(none, PHASE_POP, phase)

        # ---------- POP phase (intersect.cl:163-176)
        in_pop = phase == PHASE_POP
        restore = in_pop & (sp == msbi)
        cur_o = V.where3(jnp, restore, o, cur_o)
        cur_d = V.where3(jnp, restore, d, cur_d)
        msbi = jnp.where(restore, -1, msbi)
        sp = jnp.where(in_pop, sp - 1, sp)
        sp_c2 = jnp.clip(sp, 0, STACK_SIZE - 1)
        popped = stack[rows, sp_c2]
        node = jnp.where(in_pop & (sp >= 0), popped, node)
        phase = jnp.where(
            in_pop, jnp.where(sp >= 0, PHASE_NODE, PHASE_DONE), phase
        )

        return dict(
            phase=phase,
            node=node,
            stack=stack,
            sp=sp,
            msbi=msbi,
            cur_o=cur_o,
            cur_d=cur_d,
            inst=inst,
            cursor=cursor,
            remaining=remaining,
            best_t=best_t,
            best_tri=best_tri,
            best_inst=best_inst,
            best_u=best_u,
            best_v=best_v,
            found=found,
        )

    st = jax.lax.while_loop(cond, body, state)
    t = jnp.where(st["found"], st["best_t"], 0.0)
    return Hit(
        t, st["best_inst"], st["best_tri"], st["best_u"], st["best_v"],
        active & st["found"],
    )


def auto_mode(platform: str) -> str:
    """Traversal mode that ``auto`` resolves to on a platform.

    The CPU gets the XLA packet traversal. On the GPU the choice follows the
    end-to-end frame times in PERF.md. Any other platform has no measured
    path and is refused rather than silently given one."""
    if platform == "cpu":
        return "packet"
    if platform == "gpu":
        return GPU_AUTO_MODE
    raise RuntimeError(f"no traversal mode is measured for platform {platform!r}")


# the fastest traversal end to end on the H100 (PERF.md)
GPU_AUTO_MODE = "pallas"
MODES = ("auto", "pallas", "packet", "bvh", "brute")


def make_intersectors(
    S, scene, mode: str = "auto", brute_chunk: int = 8192, rays_per_tile: int = 64
):
    """Build (closest_hit, any_hit) callables for a compiled scene.

    mode:
      'pallas' — one-ray-per-lane GPU kernel (ops/intersect_pallas.py)
      'packet' — tile-coherent shared-stack traversal in XLA
      'bvh'    — per-lane single-ray traversal in XLA (the reference)
      'brute'  — dense all-triangles testing (tiny scenes / debugging)
      'auto'   — ``auto_mode`` of the default device's platform
    """
    if mode not in MODES:
        raise ValueError(f"unknown traversal mode {mode!r}; choose from {MODES}")
    if mode == "auto":
        mode = auto_mode(jax.devices()[0].platform)

    if mode == "pallas":
        import jax.numpy as jnp

        from .intersect_pallas import intersect_pallas, pack_scene

        P = {k: jnp.asarray(v) for k, v in pack_scene(scene).items()}

        def closest(S, o, d, maxt, active):
            return intersect_pallas(P, o, d, maxt, active, any_hit=False)

        def any_hit(S, o, d, maxt, active):
            return intersect_pallas(P, o, d, maxt, active, any_hit=True).mask

        return closest, any_hit
    if mode == "packet":
        from .intersect_packet import intersect_packet

        def closest(S, o, d, maxt, active):
            return intersect_packet(
                S, o, d, maxt, active, any_hit=False, rays_per_tile=rays_per_tile
            )

        def any_hit(S, o, d, maxt, active):
            return intersect_packet(
                S, o, d, maxt, active, any_hit=True, rays_per_tile=rays_per_tile
            ).mask

        return closest, any_hit

    if mode == "brute":
        from ..cpu_ref.renderer import _collect_blas_triangles

        ranges = []
        for root in scene.inst_bvh_root:
            tris = _collect_blas_triangles(scene, int(root))
            first, count = int(tris.min()), int(tris.size)
            assert tris.max() - first + 1 == count, "BLAS range not contiguous"
            ranges.append((first, count))
        closest = partial(
            intersect_brute, inst_tri_ranges=tuple(ranges), chunk=brute_chunk
        )

        def any_hit(S, o, d, maxt, active):
            hit = closest(S, o, d, maxt, active)
            return hit.mask

        return closest, any_hit

    def closest(S, o, d, maxt, active):
        return intersect_bvh(S, o, d, maxt, active, any_hit=False)

    def any_hit(S, o, d, maxt, active):
        return intersect_bvh(S, o, d, maxt, active, any_hit=True).mask

    return closest, any_hit
