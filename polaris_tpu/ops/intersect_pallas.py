"""Pallas GPU kernel (Triton route): two-level BVH traversal, one ray per lane.

The design follows the reference's SIMT kernels
(``rayIntersectionQuery`` / ``rayIntersectionTest``, intersect.cl:26-347):
every lane owns one ray and walks the two-level BVH on its own —
TLAS, then the instance's world->object transform, then the BLAS, with the
ray restored when the BLAS is left (intersect.cl:74-88,164-169).

  * One program traces ``BLOCK`` rays, one per GPU thread. Scene arrays stay
    in device memory and are read with per-lane gathers; the L2 holds the
    hot part of the node and triangle arrays.
  * Traversal is "while-while" (Aila & Laine 2009): an inner loop walks
    nodes until every live lane has reached a leaf or finished, then a
    second inner loop tests leaf triangles (Möller–Trumbore, one triangle
    per lane per step) until every lane has drained its leaf. Grouping the
    two kinds of work keeps a warp's lanes on the same instructions.
  * Near-child-first ordering by slab entry distance, as ops/intersect.py.
  * Each inner node stores both children's boxes (child boxes in the
    parent), so a node visit reads one contiguous 48-byte record.
  * Triton cannot index a per-lane register array, so each lane's 32-deep
    stack lives in a scratch array in device memory, laid out
    ``[program, depth, lane]``: lanes at the same depth touch consecutive
    words, and L1/L2 serve the top entries. Skip links would need no stack
    but lose near-first ordering, which closest-hit needs to cull by t.
  * Closest-hit and any-hit (exit on the first hit) share one kernel body.

Results match ``intersect_bvh`` (same epsilon semantics and slab test); on
the GPU, fused multiply-adds may move t/u/v by an ulp. On the CPU the kernel
runs in Pallas interpret mode, which is how the tests cover it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import vec as V
from .intersect import STACK_SIZE, Hit

# rays per program, one per thread: one warp. Measured on the H100 at 2^20
# rays (PERF.md): 32 rays / 1 warp beat 64/2, 128/4 and 256/8 on sphere and
# terrain819k — smaller blocks leave the while-while loops sooner.
BLOCK = 32
NUM_WARPS = 1

PHASE_NODE = 0  # visit `node`
PHASE_TRI = 1   # test triangle `cursor`, `remaining` left in the leaf
PHASE_POP = 2   # pop the next node (restoring the ray when leaving a BLAS)
PHASE_DONE = 3

_NODE_F = 12  # child boxes per inner node: left min/max xyz, right min/max xyz
_TRI_F = 9    # v0 xyz, e1 xyz, e2 xyz
_W2O_F = 12   # row-major 3x4 world->object


def _safe_inv(x):
    return 1.0 / jnp.where(jnp.abs(x) < 1e-30, jnp.where(x < 0, -1e-30, 1e-30), x)


def _any(mask):
    return jnp.max(mask.astype(jnp.int32)) > 0


def _kernel(
    links_ref,  # (N*2,) i32: bvh ldata, rdata
    boxes_ref,  # (N*12,) f32: child boxes of each inner node
    tris_ref,   # (T*9,) f32
    w2o_ref,    # (I*12,) f32
    roots_ref,  # (I,) i32 BLAS roots
    o_ref, d_ref,  # (n*3,) f32 rays
    maxt_ref,   # (n,) f32
    act_ref,    # (n,) i32
    t_ref, u_ref, v_ref, tri_ref, inst_ref, found_ref,  # (n,) outputs
    stack_ref,  # (programs*STACK_SIZE*BLOCK,) i32 scratch
    *,
    n: int,
    any_hit: bool,
):
    f32, i32 = jnp.float32, jnp.int32
    lane = jax.lax.broadcasted_iota(i32, (BLOCK,), 0)
    ray = pl.program_id(0) * BLOCK + lane
    valid = ray < n
    rc = jnp.where(valid, ray, 0)
    stack_base = pl.program_id(0) * (STACK_SIZE * BLOCK) + lane
    num_nodes = links_ref.shape[0] // 2
    num_tris = tris_ref.shape[0] // _TRI_F
    num_inst = roots_ref.shape[0]

    def gather(ref, idx, mask, other=0):
        return plgpu.load(ref.at[idx], mask=mask, other=other)

    o = [gather(o_ref, rc * 3 + k, valid, 0.0) for k in range(3)]
    d = [gather(d_ref, rc * 3 + k, valid, 1.0) for k in range(3)]
    act = valid & (gather(act_ref, rc, valid) != 0)
    maxt = gather(maxt_ref, rc, valid, 0.0)

    def transform(m, p, q):
        return (
            [m[4 * r] * p[0] + m[4 * r + 1] * p[1] + m[4 * r + 2] * p[2]
             + m[4 * r + 3] for r in range(3)],
            [m[4 * r] * q[0] + m[4 * r + 1] * q[1] + m[4 * r + 2] * q[2]
             for r in range(3)],
        )

    def where3(c, a, b):
        return [jnp.where(c, x, y) for x, y in zip(a, b)]

    # ---------------------------------------------------------- node walk
    def node_step(st):
        (phase, node, sp, msbi, inst, cursor, remaining, co, cd, ci,
         best) = st
        # pop: restore the world-space ray when leaving a BLAS
        in_pop = phase == PHASE_POP
        restore = in_pop & (sp == msbi)
        co = where3(restore, o, co)
        cd = where3(restore, d, cd)
        ci = where3(restore, [_safe_inv(x) for x in d], ci)
        msbi = jnp.where(restore, -1, msbi)
        sp = jnp.where(in_pop, sp - 1, sp)
        can_pop = in_pop & (sp >= 0)
        popped = gather(
            stack_ref, stack_base + jnp.clip(sp, 0, STACK_SIZE - 1) * BLOCK,
            can_pop,
        )
        node = jnp.where(can_pop, popped, node)
        phase = jnp.where(in_pop, jnp.where(sp >= 0, PHASE_NODE, PHASE_DONE),
                          phase)

        in_node = phase == PHASE_NODE
        nc = jnp.clip(node, 0, num_nodes - 1)
        ld = gather(links_ref, nc * 2, in_node)
        rd = gather(links_ref, nc * 2 + 1, in_node)
        is_leaf = ld <= 0
        is_top = in_node & is_leaf & (rd == 0)
        is_bot = in_node & is_leaf & (rd > 0)
        is_inner = in_node & ~is_leaf

        # top leaf: enter the instance's BLAS with a transformed ray
        inst_id = jnp.clip(-ld, 0, num_inst - 1)
        m = [gather(w2o_ref, inst_id * _W2O_F + k, is_top, 0.0)
             for k in range(_W2O_F)]
        to, td = transform(m, co, cd)
        co = where3(is_top, to, co)
        cd = where3(is_top, td, cd)
        ci = where3(is_top, [_safe_inv(x) for x in td], ci)
        inst = jnp.where(is_top, inst_id, inst)
        msbi = jnp.where(is_top, sp, msbi)
        node = jnp.where(is_top, gather(roots_ref, inst_id, is_top), node)

        # bottom leaf: hand the lane to the triangle loop
        cursor = jnp.where(is_bot, -ld, cursor)
        remaining = jnp.where(is_bot, rd, remaining)
        phase = jnp.where(is_bot, PHASE_TRI, phase)

        # inner node: slab-test both children, near first (intersect.cl:135-155)
        b = [gather(boxes_ref, nc * _NODE_F + k, is_inner, 0.0)
             for k in range(_NODE_F)]

        def slab(off):
            t0 = [(b[off + k] - co[k]) * ci[k] for k in range(3)]
            t1 = [(b[off + 3 + k] - co[k]) * ci[k] for k in range(3)]
            tmin = [jnp.minimum(x, y) for x, y in zip(t0, t1)]
            tmax = [jnp.maximum(x, y) for x, y in zip(t0, t1)]
            minmax = jnp.minimum(jnp.minimum(tmax[0], tmax[1]), tmax[2])
            maxmin = jnp.maximum(jnp.maximum(tmin[0], tmin[1]), tmin[2])
            miss = (minmax < 0.0) | (maxmin > minmax) | (maxmin >= best[0])
            return jnp.where(miss, V.FLT_MAX, maxmin)

        l_dist = slab(0)
        r_dist = slab(6)
        want_l = l_dist < V.FLT_MAX
        want_r = r_dist < V.FLT_MAX
        both = is_inner & want_l & want_r
        near_is_l = l_dist <= r_dist
        far = jnp.where(near_is_l, rd, ld)
        plgpu.store(
            stack_ref.at[stack_base + jnp.clip(sp, 0, STACK_SIZE - 1) * BLOCK],
            far, mask=both,
        )
        sp = jnp.where(both, sp + 1, sp)
        node = jnp.where(both, jnp.where(near_is_l, ld, rd), node)
        node = jnp.where(is_inner & (want_l ^ want_r),
                         jnp.where(want_l, ld, rd), node)
        phase = jnp.where(is_inner & ~want_l & ~want_r, PHASE_POP, phase)
        return (phase, node, sp, msbi, inst, cursor, remaining, co, cd, ci,
                best)

    # ------------------------------------------------------ triangle loop
    def tri_step(st):
        (phase, node, sp, msbi, inst, cursor, remaining, co, cd, ci,
         best) = st
        bt, btri, binst, bu, bv, found = best
        in_tri = phase == PHASE_TRI
        tc = jnp.clip(cursor, 0, num_tris - 1)
        tr = [gather(tris_ref, tc * _TRI_F + k, in_tri, 0.0)
              for k in range(_TRI_F)]
        v0, e1, e2 = tr[0:3], tr[3:6], tr[6:9]
        # Möller–Trumbore (intersect.cl:90-125)
        pv = [cd[1] * e2[2] - cd[2] * e2[1],
              cd[2] * e2[0] - cd[0] * e2[2],
              cd[0] * e2[1] - cd[1] * e2[0]]
        det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2]
        ok = jnp.abs(det) >= V.INTERSECTION_EPSILON
        inv_det = 1.0 / jnp.where(ok, det, 1.0)
        tv = [co[k] - v0[k] for k in range(3)]
        uu = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv_det
        ok &= (uu >= 0.0) & (uu <= 1.0)
        qv = [tv[1] * e1[2] - tv[2] * e1[1],
              tv[2] * e1[0] - tv[0] * e1[2],
              tv[0] * e1[1] - tv[1] * e1[0]]
        vv = (cd[0] * qv[0] + cd[1] * qv[1] + cd[2] * qv[2]) * inv_det
        ok &= (vv >= 0.0) & (uu + vv <= 1.0)
        tt = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv_det
        ok &= (tt > V.INTERSECTION_EPSILON) & (tt < bt)
        hit = in_tri & ok
        best = (
            jnp.where(hit, tt, bt),
            jnp.where(hit, tc, btri),
            jnp.where(hit, inst, binst),
            jnp.where(hit, uu, bu),
            jnp.where(hit, vv, bv),
            found | hit.astype(i32),
        )
        cursor = jnp.where(in_tri, cursor + 1, cursor)
        remaining = jnp.where(in_tri, remaining - 1, remaining)
        phase = jnp.where(in_tri & (remaining <= 0), PHASE_POP, phase)
        if any_hit:
            phase = jnp.where(hit, PHASE_DONE, phase)
        return (phase, node, sp, msbi, inst, cursor, remaining, co, cd, ci,
                best)

    def walking(st):
        return _any((st[0] == PHASE_NODE) | (st[0] == PHASE_POP))

    def testing(st):
        return _any(st[0] == PHASE_TRI)

    def outer(st):
        st = jax.lax.while_loop(walking, node_step, st)
        return jax.lax.while_loop(testing, tri_step, st)

    zi = jnp.zeros((BLOCK,), i32)
    zf = jnp.zeros((BLOCK,), f32)
    init = (
        jnp.where(act, PHASE_NODE, PHASE_DONE).astype(i32),
        zi, zi, zi - 1, zi, zi, zi,
        list(o), list(d), [_safe_inv(x) for x in d],
        (jnp.where(act, maxt, 0.0), zi, zi, zf, zf, zi),
    )
    st = jax.lax.while_loop(lambda s: _any(s[0] != PHASE_DONE), outer, init)
    bt, btri, binst, bu, bv, found = st[-1]
    for ref, val in ((t_ref, bt), (u_ref, bu), (v_ref, bv), (tri_ref, btri),
                     (inst_ref, binst), (found_ref, found)):
        plgpu.store(ref.at[rc], val, mask=valid)


def interpret_on(platform: str) -> bool:
    """Interpret mode on the CPU (the tests); compiled on the GPU."""
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise RuntimeError(f"the traversal kernel has no build for {platform!r}")


@functools.lru_cache(maxsize=None)
def _build_call(n: int, any_hit: bool, interpret: bool):
    grid = pl.cdiv(n, BLOCK)
    whole = lambda: pl.BlockSpec(memory_space=pl.ANY)  # noqa: E731
    out = lambda dt: jax.ShapeDtypeStruct((n,), dt)  # noqa: E731
    return pl.pallas_call(
        functools.partial(_kernel, n=n, any_hit=any_hit),
        grid=(grid,),
        in_specs=[whole() for _ in range(9)],
        out_specs=[whole() for _ in range(7)],
        out_shape=[
            out(jnp.float32), out(jnp.float32), out(jnp.float32),
            out(jnp.int32), out(jnp.int32), out(jnp.int32),
            jax.ShapeDtypeStruct((grid * STACK_SIZE * BLOCK,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="bvh_traverse_anyhit" if any_hit else "bvh_traverse_closest",
    )


def pack_scene(scene) -> dict:
    """Flatten the compiled scene into the kernel's layout (host-side).

    Inner nodes carry both children's boxes (leaves get zeros), so one node
    visit reads one contiguous record."""
    ld = scene.bvh_ldata.astype(np.int64)
    rd = scene.bvh_rdata.astype(np.int64)
    inner = ld > 0
    nmax = ld.shape[0] - 1
    li = np.clip(ld, 0, nmax)
    ri = np.clip(rd, 0, nmax)
    boxes = np.concatenate(
        [scene.bvh_min[li], scene.bvh_max[li], scene.bvh_min[ri], scene.bvh_max[ri]],
        axis=1,
    ).astype(np.float32)
    boxes[~inner] = 0.0
    tris = np.concatenate([scene.tri_v0, scene.tri_e1, scene.tri_e2], axis=1)
    return {
        "pk_links": np.stack([ld, rd], axis=1).astype(np.int32).reshape(-1),
        "pk_boxes": boxes.reshape(-1),
        "pk_tris": tris.astype(np.float32).reshape(-1),
        "pk_w2o": scene.inst_w2o[:, :3, :].astype(np.float32).reshape(-1),
        "pk_roots": scene.inst_bvh_root.astype(np.int32),
    }


def intersect_pallas(P, o, d, maxt, active, *, any_hit: bool):
    """P: packed scene dict (pack_scene); rays [N,3]/[N]. Returns Hit."""
    n = o.shape[0]
    call = _build_call(n, any_hit, interpret_on(jax.devices()[0].platform))
    t, u, v, tri, inst, found, _ = call(
        P["pk_links"], P["pk_boxes"], P["pk_tris"], P["pk_w2o"], P["pk_roots"],
        o.astype(jnp.float32).reshape(-1),
        d.astype(jnp.float32).reshape(-1),
        maxt.astype(jnp.float32),
        active.astype(jnp.int32),
    )
    found = found != 0
    return Hit(jnp.where(found, t, 0.0), inst, tri, u, v, active & found)
