"""The device integrator: one jitted program per (resolution, spp, bounces).

Counterpart of the reference's host-driven pipeline
(``tracer/opencl/pipeline.go:94-213`` MonteCarloIntegrator +
``tracer/opencl/tracer.go:194-247`` Trace): where the reference round-trips
host<->device for every kernel launch per bounce per sample (SURVEY.md §3.2),
here the *entire* sample loop — raygen, traversal, shading, NEE occlusion,
accumulation — is a single XLA program: ``lax.fori_loop`` over samples, an
unrolled bounce loop (static, small), masked fixed-shape lanes, zero host
synchronization until the final accumulator readback.

Ray i <-> pixel i throughout, so the accumulator update is a lanewise add
(no scatter). The RNG is counter-based (ops/rng.py), making the image
independent of tiling/sharding — a requirement for the multi-chip path.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..asset.camera import Camera
from ..asset.scene_data import SceneData
from ..ops import rng
from ..ops import vec as V
from ..ops.intersect import Hit, make_intersectors
from ..utils.log import Timer, get_logger
from .options import RenderOptions
from .raygen import gen_rays
from .shade import shade, shade_miss, tonemap_reinhard

_log = get_logger("renderer")


def _cumsum_tiled(a):
    """Inclusive prefix sum via a two-level (row, carry) decomposition.

    Rows scan vectorized along lanes; the 512-element carry scan is tiny.
    A flat cumsum over a whole frame inside a loop can compile
    pathologically slowly; the tiled form compiles in seconds.
    """
    n = a.shape[0]
    r = 512
    while r > 1 and n % r:
        r //= 2
    if r <= 1:
        return jnp.cumsum(a)
    m = a.reshape(r, n // r)
    row = jnp.cumsum(m, axis=1)
    carry = jnp.concatenate(
        [jnp.zeros((1,), a.dtype), jnp.cumsum(row[:, -1])[:-1]]
    )
    return (row + carry[:, None]).reshape(-1)


def _compact_pos(mask):
    """Stable partition target slots: masked lanes first, others after.

    cumsum-based (no sort): position[i] = rank of lane i within its class.
    Used to pack live rays into the leading traversal tiles so the packet
    kernels' all-dead-tile early exit turns low occupancy into real savings
    (the reference gets the same effect from its atomic compaction queues,
    pt_integrator.cl:49-64).
    """
    a = mask.astype(jnp.int32)
    live_pos = _cumsum_tiled(a) - 1
    n_live = jnp.sum(a)
    dead_pos = n_live + _cumsum_tiled(1 - a) - 1
    return jnp.where(mask, live_pos, dead_pos)


def _inv_perm(pos):
    """Invert a permutation with ONE int scatter; data then moves with row
    gathers (scatters are slower than gathers)."""
    n = pos.shape[0]
    return jnp.zeros(n, pos.dtype).at[pos].set(jnp.arange(n, dtype=pos.dtype))


def _scatter_to(pos, x):
    return jnp.zeros_like(x).at[pos].set(x)


def _part1by2(x):
    """Spread the low 10 bits of x across every 3rd bit (Morton helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _octant_key(d, mask):
    """Bucket id per lane: direction octant (0..7), dead lanes last (8)."""
    octant = (
        (d[..., 0] < 0).astype(jnp.int32)
        | ((d[..., 1] < 0).astype(jnp.int32) << 1)
        | ((d[..., 2] < 0).astype(jnp.int32) << 2)
    )
    return jnp.where(mask, octant, jnp.int32(8))


def _bucket_positions(key, num_buckets: int):
    """Stable counting-sort target slots via tiled prefix sums.

    A handful of tiled cumsums stands in for a full jax.lax.sort.
    Stability preserves the blocked lane order inside each bucket, which is
    what keeps ray-origin coherence intact.
    """
    pos = jnp.zeros(key.shape, jnp.int32)
    offset = jnp.int32(0)
    for b in range(num_buckets):
        m = key == b
        c = _cumsum_tiled(m.astype(jnp.int32))
        pos = jnp.where(m, offset + c - 1, pos)
        offset = offset + c[-1]
    return pos


def make_sorted_pass():
    """Wrap an intersector so each call traverses rays grouped by direction
    octant, dead lanes packed last.

    Bounce-ray *origins* are already block-coherent (they sit where a
    coherent primary block hit); a packet traversal's remaining cost driver
    is direction divergence within a tile. A stable octant
    partition groups rays that descend the BVH the same way while keeping
    same-block rays adjacent, and dead-lanes-last turns the kernel's
    all-dead tile skip into free compaction WITHOUT destroying spatial
    coherence (plain cumsum compaction loses exactly that). Hits are
    scattered back to lane order; images are bit-identical because the RNG
    keys by pixel id, not lane order.
    """

    def wrap(fn, any_hit: bool):
        def run(S, o, d, maxt, mask):
            key = _octant_key(d, mask)
            pos = _bucket_positions(key, 9)
            perm = _inv_perm(pos)  # slot -> lane
            res = fn(S, o[perm], d[perm], maxt[perm], mask[perm])
            if any_hit:
                return res[pos]
            return Hit(
                res.t[pos], res.inst[pos], res.tri[pos],
                res.u[pos], res.v[pos], res.mask[pos],
            )

        return run

    return wrap


TILE_LANES = 1024  # lanes per adaptive-sampling block (32x32 pixels)


# pixel-block edge of the blocked lane order: 1024 consecutive lanes cover
# one 32x32 screen block (adaptive blocks and rng.rr_block_key use the same)
PIXEL_BLOCK = 32


def blocked_pixel_order(width: int, height: int, block: int = PIXEL_BLOCK):
    """Host-side lane->pixel mapping in block x block screen tiles.

    A traversal tile of 1024 consecutive lanes then covers a 32x32 pixel
    block instead of a 2-row strip: primary cones and bounce-ray origin
    clusters shrink ~16x in extent, tightening the packet kernels' node
    unions for every pass. Returns (xs, ys, pixel_idx, inv_lane) as numpy
    arrays; inv_lane[p] is the lane holding pixel p (constant gather used
    once per render to restore pixel order). Falls back to row-major when
    the frame doesn't divide into blocks.
    """
    n = width * height
    if width % block or height % block:
        idx = np.arange(n, dtype=np.int64)
        return (
            (idx % width).astype(np.int32),
            (idx // width).astype(np.int32),
            idx.astype(np.uint32),
            idx.astype(np.int32),
        )
    bw = width // block
    lane = np.arange(n, dtype=np.int64)
    b = lane // (block * block)
    within = lane % (block * block)
    bx = (b % bw) * block
    by = (b // bw) * block
    xs = (bx + within % block).astype(np.int32)
    ys = (by + within // block).astype(np.int32)
    pixel_idx = (ys.astype(np.int64) * width + xs).astype(np.uint32)
    inv_lane = np.empty(n, np.int64)
    inv_lane[pixel_idx] = lane
    return xs, ys, pixel_idx, inv_lane.astype(np.int32)


def render_sample_block(
    S: Dict,
    closest,
    any_hit,
    *,
    frustum,
    eye,
    width: int,
    height: int,
    pixel_x,
    pixel_y,
    pixel_idx,
    sample_idx,
    seed,
    num_bounces: int,
    min_bounces_for_rr: int,
    num_emissives: int,
    scene_diffuse_mat: int,
    material_depth: int = None,
    compact: bool = False,
    unroll: bool = False,
    rr_tile_coherent: bool = False,
    active_init=None,
):
    """Trace ONE sample for a block of pixels; returns radiance [N, 3].

    This is the building block shared by the single-chip renderer, the
    shard_map multi-chip renderer, and the differentiable path. ``pixel_*``
    are full-frame coordinates so a sharded block behaves exactly like the
    reference's BlockY-offset row bands (camera.cl:32, default.go:127-136).
    """
    n = pixel_idx.shape[0]
    pixel_idx = pixel_idx.astype(jnp.uint32)
    U0 = rng.make_uniform(rng.jnp_uniform, seed, pixel_idx, sample_idx, 0)
    ray_o, ray_d = gen_rays(jnp, frustum, eye, width, height, pixel_x, pixel_y, U0)
    throughput = jnp.ones((n, 3), jnp.float32)
    flags = jnp.zeros(n, jnp.uint32)
    # adaptive sampling masks whole 32x32 blocks off; dead tiles then skip
    # traversal outright (the kernels' all-dead-tile vote)
    alive = jnp.ones(n, bool) if active_init is None else active_init
    radiance = jnp.zeros((n, 3), jnp.float32)
    maxt = jnp.full(n, V.FLT_MAX, jnp.float32)

    sg = jax.lax.stop_gradient

    def make_bounce_body(closest_fn):
        def bounce_body(carry, b):
            return _bounce_body(closest_fn, carry, b)

        return bounce_body

    def _bounce_body(closest_fn, carry, b):
        ray_o, ray_d, throughput, flags, alive, radiance, pix, lane = carry
        if compact:
            # pack live lanes into the leading tiles; the RNG is keyed by
            # the carried pixel id so results are lane-order invariant
            pos = _compact_pos(alive)
            inv = _inv_perm(pos)
            ray_o = ray_o[inv]
            ray_d = ray_d[inv]
            throughput = throughput[inv]
            flags = flags[inv]
            radiance = radiance[inv]
            pix = pix[inv]
            lane = lane[inv]
            alive = alive[inv]
        # Hit geometry is non-differentiable by design: the traversal is a
        # lax.while_loop (no JVP/transpose rules), so every differentiable
        # input is gradient-stopped — the loop never enters the tangent
        # program. Gradients flow through shading, textures and the camera
        # ray parameters instead (SURVEY.md §7 'Differentiability').
        hit = closest_fn(S, sg(ray_o), sg(ray_d), sg(maxt), alive)
        hit = jax.lax.stop_gradient(hit)
        t = jnp.where(hit.mask, hit.t, 0.0)
        if scene_diffuse_mat >= 0:
            miss = alive & (~hit.mask)
            bg = shade_miss(jnp, S, ray_d, throughput, b == 0, scene_diffuse_mat)
            radiance = radiance + jnp.where(miss[..., None], bg, 0.0)
        rr_key = (
            rng.rr_block_key(jnp, pix, width) if rr_tile_coherent else None
        )
        U = rng.make_uniform(
            rng.jnp_uniform, seed, pix, sample_idx, b, rr_key=rr_key
        )
        out = shade(
            jnp,
            S,
            U,
            bounce=b,
            min_bounces_for_rr=min_bounces_for_rr,
            num_emissives=num_emissives,
            material_depth=material_depth,
            ray_o=ray_o,
            ray_d=ray_d,
            t=t,
            inst=hit.inst,
            tri=hit.tri,
            bary_u=hit.u,
            bary_v=hit.v,
            hit_mask=hit.mask,
            throughput=throughput,
            flags=flags,
        )
        radiance = radiance + out["emit_add"]
        if num_emissives > 0:
            om = out["occl_mask"]
            if compact:
                # shadow rays are far sparser than live lanes (SURVEY noise
                # analysis: ~7% lanes over ~69% tiles at bounce 1) — pack
                # them separately and map the verdicts back
                opos = _compact_pos(om)
                oinv = _inv_perm(opos)
                occluded_c = any_hit(
                    S,
                    sg(out["occl_o"][oinv]),
                    sg(out["occl_d"][oinv]),
                    sg(out["occl_maxt"][oinv]),
                    om[oinv],
                )
                occluded = occluded_c[opos]
            else:
                occluded = any_hit(
                    S, sg(out["occl_o"]), sg(out["occl_d"]), sg(out["occl_maxt"]),
                    om,
                )
            nee = om & (~occluded)
            radiance = radiance + jnp.where(nee[..., None], out["occl_value"], 0.0)
        carry = (
            out["next_o"],
            out["next_d"],
            out["throughput"],
            out["flags"],
            out["next_mask"],
            radiance,
            pix,
            lane,
        )
        return carry, None

    # one compiled bounce body, scanned num_bounces times (SURVEY.md §3.2:
    # the reference re-launches 6 kernels per bounce from the host; here the
    # bounce loop lives inside the XLA program)
    lane_ids = jnp.arange(n, dtype=jnp.int32)
    carry = (ray_o, ray_d, throughput, flags, alive, radiance, pixel_idx, lane_ids)
    if compact or unroll:
        # unrolled bounce loop: the compaction and sorting permutations are
        # large gathers, kept out of lax.scan. Sorted-traversal mode
        # permutes rays per bounce, so it needs the unroll too.
        for b in range(num_bounces):
            carry, _ = make_bounce_body(closest)(carry, jnp.uint32(b))
    else:
        carry, _ = jax.lax.scan(
            make_bounce_body(closest), carry,
            jnp.arange(num_bounces, dtype=jnp.uint32),
        )
    radiance, lane = carry[-3], carry[-1]
    if compact:
        # radiance is in compacted lane order; restore pixel order with one
        # int scatter + gather (lane is the carried *local* id — pix is the
        # full-frame index, wrong for sharded row blocks)
        radiance = radiance[_inv_perm(lane.astype(jnp.int32))]
    return radiance


def render_block_regen(
    S: Dict,
    closest,
    any_hit,
    *,
    frustum,
    eye,
    width: int,
    height: int,
    pixel_x,
    pixel_y,
    pixel_idx,
    sample_offset,
    spp: int,
    seed,
    num_bounces: int,
    min_bounces_for_rr: int,
    num_emissives: int,
    scene_diffuse_mat: int,
    material_depth: int = None,
    rr_tile_coherent: bool = False,
):
    """Wavefront PATH REGENERATION: all ``spp`` samples of the block in one
    flat loop; the moment a lane's path ends (RR death, absorbed bounce,
    miss, bounce cap) it restarts at its OWN pixel with its next sample
    index — the occupancy purpose of the reference's atomic compaction
    queues (pt_integrator.cl:49-64), without the two measured killers of
    XLA-level compaction: no permutation and no coherence loss (the
    pixel<->lane binding never changes, and regenerated rays are
    block-coherent primaries).

    The RNG keys every draw by (pixel, sample, bounce, stream), so each
    path sees EXACTLY the draws the sequential sample loop gives it — the
    estimator is unchanged; only the float accumulation order differs
    (contributions stream into one accumulator in per-lane chronological
    order instead of per-sample partial sums, ~1 ulp association noise).

    Runs as a ``lax.while_loop`` until every lane exhausts its sample
    budget: expected trip count ~ spp * E[path length] + tail instead of
    the sequential spp * num_bounces, and whole 32x32 tiles whose lanes
    all finish early are skipped in-kernel by the all-dead-tile vote.
    Termination is guaranteed: b strictly increases to the bounce cap and
    s strictly increases on every regeneration, so trips <= spp *
    num_bounces. Forward-only (while_loop has no transpose rule); the
    differentiable paths keep the sequential integrator.
    """
    n = pixel_idx.shape[0]
    pixel_idx = pixel_idx.astype(jnp.uint32)
    maxt = jnp.full(n, V.FLT_MAX, jnp.float32)
    sg = jax.lax.stop_gradient
    s_end = sample_offset + spp

    def primary(s_idx):
        U0 = rng.make_uniform(rng.jnp_uniform, seed, pixel_idx, s_idx, 0)
        return gen_rays(
            jnp, frustum, eye, width, height, pixel_x, pixel_y, U0
        )

    s0 = jnp.full(n, 1, jnp.int32) * sample_offset  # broadcast traced scalar
    ray_o, ray_d = primary(s0)
    carry = (
        ray_o,
        ray_d,
        jnp.ones((n, 3), jnp.float32),  # throughput
        jnp.zeros(n, jnp.uint32),  # flags
        jnp.ones(n, bool),  # alive
        jnp.zeros((n, 3), jnp.float32),  # radiance
        s0,  # per-lane absolute sample index
        jnp.zeros(n, jnp.uint32),  # per-lane bounce
        jnp.int32(0),  # trip counter (diagnostics)
    )

    def cond(carry):
        return jnp.any(carry[4])

    def body(carry):
        ray_o, ray_d, throughput, flags, alive, radiance, s, b, trips = carry
        hit = closest(S, sg(ray_o), sg(ray_d), sg(maxt), alive)
        hit = jax.lax.stop_gradient(hit)
        t = jnp.where(hit.mask, hit.t, 0.0)
        if scene_diffuse_mat >= 0:
            miss = alive & (~hit.mask)
            bg = shade_miss(
                jnp, S, ray_d, throughput, (b == 0)[..., None],
                scene_diffuse_mat,
            )
            radiance = radiance + jnp.where(miss[..., None], bg, 0.0)
        rr_key = (
            rng.rr_block_key(jnp, pixel_idx, width)
            if rr_tile_coherent
            else None
        )
        U = rng.make_uniform(
            rng.jnp_uniform, seed, pixel_idx, s, b, rr_key=rr_key
        )
        out = shade(
            jnp,
            S,
            U,
            bounce=b,
            min_bounces_for_rr=min_bounces_for_rr,
            num_emissives=num_emissives,
            material_depth=material_depth,
            ray_o=ray_o,
            ray_d=ray_d,
            t=t,
            inst=hit.inst,
            tri=hit.tri,
            bary_u=hit.u,
            bary_v=hit.v,
            hit_mask=hit.mask,
            throughput=throughput,
            flags=flags,
        )
        radiance = radiance + out["emit_add"]
        if num_emissives > 0:
            om = out["occl_mask"]
            occluded = any_hit(
                S, sg(out["occl_o"]), sg(out["occl_d"]),
                sg(out["occl_maxt"]), om,
            )
            nee = om & (~occluded)
            radiance = radiance + jnp.where(
                nee[..., None], out["occl_value"], 0.0
            )
        cont = alive & out["next_mask"] & (b + 1 < num_bounces)
        regen = alive & (~cont) & (s + 1 < s_end)
        new_s = jnp.where(regen, s + 1, s)
        o0, d0 = primary(new_s)  # cheap vector math; where-selected below
        ray_o = jnp.where(regen[..., None], o0, out["next_o"])
        ray_d = jnp.where(regen[..., None], d0, out["next_d"])
        throughput = jnp.where(
            regen[..., None], 1.0, out["throughput"]
        )
        flags = jnp.where(regen, jnp.uint32(0), out["flags"])
        b = jnp.where(cont, b + 1, jnp.uint32(0))
        alive = cont | regen
        return (
            ray_o, ray_d, throughput, flags, alive, radiance, new_s, b,
            trips + 1,
        )

    carry = jax.lax.while_loop(cond, body, carry)
    return carry[5], carry[8]


class TpuRenderer:
    """Single-chip renderer over a compiled scene.

    ``mode`` selects the traversal backend ('auto' | 'bvh' | 'brute' |
    'pallas' once available). ``regen`` switches the sample loop to
    wavefront path regeneration (render_block_regen).
    """

    def __init__(
        self,
        scene: SceneData,
        mode: str = "auto",
        compact: bool = False,
        sort_rays: bool = False,
        batch_samples: bool = False,
        regen: bool = False,
    ):
        self.scene = scene
        self.compact = compact
        self.sort_rays = sort_rays
        self.batch_samples = batch_samples
        self.regen = regen and not (compact or sort_rays or batch_samples)
        geom, params = scene.split_params()
        self.geom = {
            k: v if k.startswith("_") else jnp.asarray(v) for k, v in geom.items()
        }
        self.params = {k: jnp.asarray(v) for k, v in params.items()}
        self.closest, self.any_hit = make_intersectors(None, scene, mode)
        if sort_rays:
            # coherence-sort every traversal pass (see make_sorted_pass)
            wrap = make_sorted_pass()
            self.closest = wrap(self.closest, any_hit=False)
            self.any_hit = wrap(self.any_hit, any_hit=True)
        self.num_emissives = int(scene.emis_area.shape[0])
        self.scene_diffuse_mat = int(scene.scene_diffuse_mat)
        from ..ops.material import material_tree_depth

        self.material_depth = material_tree_depth(
            scene.mat_type, scene.mat_left, scene.mat_right
        )
        self._jit_cache: Dict = {}

    # ----- jit plumbing -----

    def _get_render_fn(self, opt: RenderOptions, emit: str = "f32"):
        key = (opt.width, opt.height, opt.spp, opt.num_bounces,
               opt.min_bounces_for_rr, opt.rr_tile_coherent,
               emit, opt.exposure if emit == "u8" else None)
        if key in self._jit_cache:
            return self._jit_cache[key]

        W, H = opt.width, opt.height
        n = W * H

        # lane->pixel mapping in 32x32 screen blocks (host constants): each
        # run of 1024 lanes covers a compact screen block, keeping the rays
        # of a traversal block or packet coherent in every pass
        h_xs, h_ys, h_pix, h_inv = blocked_pixel_order(W, H)
        blocked = not np.array_equal(h_pix, np.arange(n, dtype=np.uint32))

        if self.batch_samples and opt.spp > 1:
            # sample-batched wavefront: all spp samples of a launch ride as
            # one wide lane batch (B*n lanes, sample-major so tiles stay
            # within one sample's screen block). Measured NEUTRAL on sphere
            # 512^2 (40.5 vs 41.8 Mrays/s) — per-pass launch overhead is
            # negligible in the compiled loop, so amortizing it buys nothing
            # and the 8x-larger live set costs a little. Kept as a mode for
            # low-spp progressive passes. Partials are reduced in sample
            # order, keeping the image bit-identical to the sequential loop.
            B = opt.spp
            b_xs = np.tile(h_xs, B)
            b_ys = np.tile(h_ys, B)
            b_pix = np.tile(h_pix, B)
            b_sample = np.repeat(np.arange(B, dtype=np.int32), n)

            def render_fn(geom, params, frustum, eye, seed, sample_offset):
                S = {**geom, **params}
                rad = render_sample_block(
                    S,
                    self.closest,
                    self.any_hit,
                    frustum=frustum,
                    eye=eye,
                    width=W,
                    height=H,
                    pixel_x=jnp.asarray(b_xs),
                    pixel_y=jnp.asarray(b_ys),
                    pixel_idx=jnp.asarray(b_pix),
                    sample_idx=sample_offset + jnp.asarray(b_sample),
                    seed=seed,
                    num_bounces=opt.num_bounces,
                    min_bounces_for_rr=opt.min_bounces_for_rr,
                    num_emissives=self.num_emissives,
                    scene_diffuse_mat=self.scene_diffuse_mat,
                    material_depth=self.material_depth,
                    rr_tile_coherent=opt.rr_tile_coherent,
                    compact=self.compact,
                    unroll=self.sort_rays,
                )
                parts = rad.reshape(B, n, 3)
                accum = parts[0]
                for s in range(1, B):  # sequential adds = fori_loop order
                    accum = accum + parts[s]
                if blocked:
                    accum = accum[jnp.asarray(h_inv)]
                return self._emit(accum.reshape(H, W, 3), opt, emit)

            fn = jax.jit(render_fn)
            self._jit_cache[key] = fn
            return fn

        def render_fn(geom, params, frustum, eye, seed, sample_offset):
            S = {**geom, **params}
            accum = self._block_partial(
                S, opt, frustum, eye, seed, sample_offset, h_xs, h_ys,
                h_pix,
            )
            if blocked:
                # one constant-index gather restores pixel order (outside all
                # loops — cheap, and RNG keys by pixel id so the image is
                # bit-identical to row-major lane order)
                accum = accum[jnp.asarray(h_inv)]
            return self._emit(accum.reshape(H, W, 3), opt, emit)

        fn = jax.jit(render_fn)
        self._jit_cache[key] = fn
        return fn

    def _block_partial(self, S, opt: RenderOptions, frustum, eye, seed,
                       sample_offset, h_xs, h_ys, h_pix):
        """Sum of ``opt.spp`` samples' radiance in BLOCKED lane order — the
        single implementation behind both the one-shot program and the
        chunk-carry program (they must stay in lock-step or chunked and
        whole renders diverge). Dispatches to wavefront regeneration or
        the sequential sample loop."""
        W, H = opt.width, opt.height
        n = W * H
        pixel_idx = jnp.asarray(h_pix)
        xs = jnp.asarray(h_xs)
        ys = jnp.asarray(h_ys)
        if self.regen:
            part, _ = render_block_regen(
                S,
                self.closest,
                self.any_hit,
                frustum=frustum,
                eye=eye,
                width=W,
                height=H,
                pixel_x=xs,
                pixel_y=ys,
                pixel_idx=pixel_idx,
                sample_offset=sample_offset,
                spp=opt.spp,
                seed=seed,
                num_bounces=opt.num_bounces,
                min_bounces_for_rr=opt.min_bounces_for_rr,
                num_emissives=self.num_emissives,
                scene_diffuse_mat=self.scene_diffuse_mat,
                material_depth=self.material_depth,
                rr_tile_coherent=opt.rr_tile_coherent,
            )
            return part

        def sample_body(s, accum):
            rad = render_sample_block(
                S,
                self.closest,
                self.any_hit,
                frustum=frustum,
                eye=eye,
                width=W,
                height=H,
                pixel_x=xs,
                pixel_y=ys,
                pixel_idx=pixel_idx,
                sample_idx=sample_offset + s,
                seed=seed,
                num_bounces=opt.num_bounces,
                min_bounces_for_rr=opt.min_bounces_for_rr,
                num_emissives=self.num_emissives,
                scene_diffuse_mat=self.scene_diffuse_mat,
                material_depth=self.material_depth,
                rr_tile_coherent=opt.rr_tile_coherent,
                compact=self.compact,
                unroll=self.sort_rays,
            )
            return accum + rad

        return jax.lax.fori_loop(
            0, opt.spp, sample_body, jnp.zeros((n, 3), jnp.float32)
        )

    @staticmethod
    def _emit(accum, opt: RenderOptions, emit: str):
        """Optionally fuse LDR conversion into the render program: a
        single-launch u8 frame then needs no second tonemap dispatch."""
        if emit == "f32":
            return accum
        img = tonemap_reinhard(
            jnp, accum, jnp.float32(1.0 / opt.spp), jnp.float32(opt.exposure)
        )
        return (jnp.clip(img, 0.0, 1.0) * 255.0).astype(jnp.uint8)

    def _get_chunk_carry_fn(self, opt: RenderOptions):
        """Chunk program that carries the accumulator in BLOCKED lane order
        across launches (round-4 VERDICT item 3): the per-chunk unblock
        gather, accumulator zeroing and host-side adds of the old chunk loop
        recur per launch (~48 ms of the 87 ms fixed frame cost); here each
        launch adds its chunk's partial sum to a donated device carry and
        pixel order is restored ONCE by the finalize program. The chunk
        partial is summed from zero and added at the end, so the float
        association — (chunk0)+(chunk1)+... — is identical to the old
        host-side adds and images stay bit-identical."""
        key = ("chunkc", opt.width, opt.height, opt.spp, opt.num_bounces,
               opt.min_bounces_for_rr, opt.rr_tile_coherent)
        if key in self._jit_cache:
            return self._jit_cache[key]
        h_xs, h_ys, h_pix, _ = blocked_pixel_order(opt.width, opt.height)

        def render_fn(geom, params, frustum, eye, seed, sample_offset,
                      accum_in):
            S = {**geom, **params}
            part = self._block_partial(
                S, opt, frustum, eye, seed, sample_offset, h_xs, h_ys,
                h_pix,
            )
            return accum_in + part

        fn = jax.jit(render_fn, donate_argnums=(6,))
        self._jit_cache[key] = fn
        return fn

    def _get_finalize_fn(self, W: int, H: int, emit: str):
        """One tiny program closing a chunked render: restore pixel order
        from blocked lane order (single constant-index gather) and, for u8
        frames, tonemap + quantize — fetching 0.75 MB instead of 3 MB."""
        key = ("fin", W, H, emit)
        if key in self._jit_cache:
            return self._jit_cache[key]
        n = W * H
        _, _, h_pix, h_inv = blocked_pixel_order(W, H)
        blocked = not np.array_equal(h_pix, np.arange(n, dtype=np.uint32))

        def fin(accum, sample_weight, exposure):
            a = accum[jnp.asarray(h_inv)] if blocked else accum
            a = a.reshape(H, W, 3)
            if emit == "f32":
                return a
            img = tonemap_reinhard(jnp, a, sample_weight, exposure)
            return (jnp.clip(img, 0.0, 1.0) * 255.0).astype(jnp.uint8)

        fn = jax.jit(fin)
        self._jit_cache[key] = fn
        return fn

    def _render_accum_blocked(self, opt: RenderOptions, camera=None):
        """Render opt.spp samples in spp_per_launch chunks, returning the
        device accumulator in blocked lane order. Launches queue
        asynchronously (no per-chunk host sync), so dispatching one chunk
        overlaps the previous chunk's execution."""
        from dataclasses import replace

        cam = camera or Camera.from_scene(self.scene, opt.width, opt.height)
        frustum = jnp.asarray(cam.frustum)
        eye = jnp.asarray(cam.position)
        n = opt.width * opt.height
        accum = jnp.zeros((n, 3), jnp.float32)
        done = 0
        while done < opt.spp:
            chunk = min(self.spp_per_launch, opt.spp - done)
            fn = self._get_chunk_carry_fn(replace(opt, spp=chunk))
            accum = fn(
                self.geom,
                self.params,
                frustum,
                eye,
                jnp.uint32(opt.seed),
                jnp.int32(done),
                accum,
            )
            done += chunk
        return accum

    # ----- public API -----

    # samples per device launch: bounds one execution's wall time and its
    # compile unit (≙ the reference's per-sample host loop,
    # tracer.go:221-241, without its per-kernel sync cost)
    spp_per_launch = 8

    def render_accum(
        self, opt: RenderOptions, camera: Optional[Camera] = None
    ) -> jnp.ndarray:
        if opt.spp > self.spp_per_launch:
            if self.batch_samples:
                # the sample-batched program has its own lane layout; keep
                # the original per-chunk host accumulation for it
                from dataclasses import replace

                total_ms = 0.0
                accum = None
                done = 0
                while done < opt.spp:
                    chunk = min(self.spp_per_launch, opt.spp - done)
                    copt = replace(opt, spp=chunk)
                    part = self.render_accum_offset(
                        copt, camera, sample_offset=done
                    )
                    total_ms += self.last_render_ms
                    accum = part if accum is None else accum + part
                    done += chunk
                self.last_render_ms = total_ms
                return accum
            fin = self._get_finalize_fn(opt.width, opt.height, "f32")
            with Timer() as t:
                accum = self._render_accum_blocked(opt, camera)
                out = fin(accum, jnp.float32(1.0), jnp.float32(1.0))
                out.block_until_ready()
            self.last_render_ms = t.ms
            return out
        return self.render_accum_offset(opt, camera, sample_offset=0)

    def render_accum_offset(
        self,
        opt: RenderOptions,
        camera: Optional[Camera] = None,
        sample_offset: int = 0,
    ) -> jnp.ndarray:
        """Render opt.spp samples starting at an absolute sample index —
        progressive accumulation reuses the same compiled program."""
        cam = camera or Camera.from_scene(self.scene, opt.width, opt.height)
        fn = self._get_render_fn(opt)
        with Timer() as t:
            accum = fn(
                self.geom,
                self.params,
                jnp.asarray(cam.frustum),
                jnp.asarray(cam.position),
                jnp.uint32(opt.seed),
                jnp.int32(sample_offset),
            )
            accum.block_until_ready()
        self.last_render_ms = t.ms
        return accum

    def render(self, opt: RenderOptions, camera: Optional[Camera] = None):
        accum = self.render_accum(opt, camera)
        img = tonemap_reinhard(jnp, accum, 1.0 / opt.spp, opt.exposure)
        return np.asarray(img)

    # ----- adaptive per-block sampling (round-4 VERDICT weak #3) -----
    #
    # The lockstep answer to the reference's compaction queues
    # (pt_integrator.cl:49-64): instead of compacting lanes, whole 32x32
    # screen blocks stop drawing samples once their per-pixel variance says
    # they converged. A masked block's lanes start inactive and skip
    # traversal, so a stopped block costs little. The
    # RNG's absolute sample indices make the result reproducible: a block
    # that stopped at n samples holds exactly the accumulator a fixed
    # n-sample render would produce (tests/test_adaptive.py pins this).

    def _get_adaptive_fn(self, opt: RenderOptions, chunk: int):
        key = ("adapt", opt.width, opt.height, chunk, opt.num_bounces,
               opt.min_bounces_for_rr, opt.rr_tile_coherent)
        if key in self._jit_cache:
            return self._jit_cache[key]
        W, H = opt.width, opt.height
        n = W * H
        h_xs, h_ys, h_pix, _ = blocked_pixel_order(W, H)
        nblocks = -(-n // TILE_LANES)
        lane_block = np.minimum(
            np.arange(n, dtype=np.int64) // TILE_LANES, nblocks - 1
        ).astype(np.int32)
        pad = nblocks * TILE_LANES - n

        def fn(geom, params, frustum, eye, seed, sample_offset,
               block_active, block_spp, accum, lsum, l2sum):
            S = {**geom, **params}
            act = block_active[jnp.asarray(lane_block)]
            xs = jnp.asarray(h_xs)
            ys = jnp.asarray(h_ys)
            pixel_idx = jnp.asarray(h_pix)

            def sample_body(s, carry):
                accum, lsum, l2sum = carry
                rad = render_sample_block(
                    S,
                    self.closest,
                    self.any_hit,
                    frustum=frustum,
                    eye=eye,
                    width=W,
                    height=H,
                    pixel_x=xs,
                    pixel_y=ys,
                    pixel_idx=pixel_idx,
                    sample_idx=sample_offset + s,
                    seed=seed,
                    num_bounces=opt.num_bounces,
                    min_bounces_for_rr=opt.min_bounces_for_rr,
                    num_emissives=self.num_emissives,
                    scene_diffuse_mat=self.scene_diffuse_mat,
                    material_depth=self.material_depth,
                    rr_tile_coherent=opt.rr_tile_coherent,
                    compact=self.compact,
                    unroll=self.sort_rays,
                    active_init=act,
                )
                lum = V.luminance(jnp, rad)
                return accum + rad, lsum + lum, l2sum + lum * lum

            accum, lsum, l2sum = jax.lax.fori_loop(
                0, chunk, sample_body, (accum, lsum, l2sum)
            )
            # per-block convergence stat: 95% CI of the mean per-sample
            # luminance, relative to the mean (0.05 floor keeps black and
            # near-black blocks from never converging)
            ns = jnp.maximum(block_spp[jnp.asarray(lane_block)], 1.0)
            mean = lsum / ns
            var = jnp.maximum(l2sum / ns - mean * mean, 0.0)
            ci = 1.96 * jnp.sqrt(var / ns) / (mean + 0.05)
            ci = jnp.pad(ci, (0, pad))
            # block stat = mean per-pixel CI: a max would let one firefly
            # pixel hold a whole block at full budget forever; divide by
            # each block's REAL lane count (the zero-padded tail block
            # would otherwise under-read its CI and stop too early)
            lanes_per_block = jnp.asarray(
                np.minimum(
                    TILE_LANES,
                    n - np.arange(nblocks, dtype=np.int64) * TILE_LANES,
                ).astype(np.float32)
            )
            block_ci = (
                ci.reshape(nblocks, TILE_LANES).sum(axis=1) / lanes_per_block
            )
            return accum, lsum, l2sum, block_ci

        fn = jax.jit(fn)
        self._jit_cache[key] = fn
        return fn

    def render_adaptive(
        self,
        opt: RenderOptions,
        camera: Optional[Camera] = None,
        *,
        tol: float = 0.02,
        chunk: int = 0,
        min_spp: int = 0,
    ):
        """Variance-driven adaptive render. ``opt.spp`` is the per-pixel
        budget CAP; blocks stop early once converged (95% CI of mean
        luminance below ``tol`` relative). Returns ``(accum [H,W,3],
        spp_map [H,W] int32)`` — divide per pixel to get the image."""
        W, H = opt.width, opt.height
        n = W * H
        nblocks = -(-n // TILE_LANES)
        chunk = chunk or min(self.spp_per_launch, opt.spp)
        min_spp = min_spp or min(2 * chunk, opt.spp)
        fn = self._get_adaptive_fn(opt, chunk)
        cam = camera or Camera.from_scene(self.scene, W, H)
        accum = jnp.zeros((n, 3), jnp.float32)
        lsum = jnp.zeros(n, jnp.float32)
        l2sum = jnp.zeros(n, jnp.float32)
        block_active = np.ones(nblocks, bool)
        block_spp = np.zeros(nblocks, np.int32)
        done = 0
        total_ms = 0.0
        while done < opt.spp and block_active.any():
            k = min(chunk, opt.spp - done)  # never exceed the budget cap
            fn = self._get_adaptive_fn(opt, k) if k != chunk else fn
            block_spp_new = block_spp + np.where(block_active, k, 0)
            with Timer() as t:
                accum, lsum, l2sum, block_ci = fn(
                    self.geom,
                    self.params,
                    jnp.asarray(cam.frustum),
                    jnp.asarray(cam.position),
                    jnp.uint32(opt.seed),
                    jnp.int32(done),
                    jnp.asarray(block_active),
                    jnp.asarray(block_spp_new, jnp.float32),
                    accum, lsum, l2sum,
                )
                accum.block_until_ready()
            total_ms += t.ms
            block_spp = block_spp_new
            done += k
            if done >= min_spp:
                # >= keeps tol=0 a true "never converge" mode: a
                # zero-variance block (mean=var=0 -> ci exactly 0) must not
                # stop at min_spp, or the documented tol=0
                # bit-identical-to-uniform guarantee breaks (ADVICE r4 #1)
                block_active &= np.asarray(block_ci) >= tol
        self.last_render_ms = total_ms
        self.last_spp_blocks = block_spp
        lane_block = np.minimum(
            np.arange(n, dtype=np.int64) // TILE_LANES, nblocks - 1
        )
        _, _, h_pix, h_inv = blocked_pixel_order(W, H)
        spp_lane = block_spp[lane_block]
        accum = np.asarray(accum)[h_inv].reshape(H, W, 3)
        spp_map = spp_lane[h_inv].reshape(H, W).astype(np.int32)
        return accum, spp_map

    def render_adaptive_u8(
        self, opt: RenderOptions, camera: Optional[Camera] = None, **kw
    ):
        accum, spp_map = self.render_adaptive(opt, camera, **kw)
        img = tonemap_reinhard(
            np, accum, 1.0 / spp_map[..., None].astype(np.float32),
            opt.exposure,
        )
        return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8), spp_map

    # ----- row-band rendering (feedback-scheduler work units) -----

    def _get_band_fn(self, opt: RenderOptions, band_h: int):
        """Jitted program rendering a [band_h, W] row band whose top row is a
        *traced* argument: all equal-height bands share one compiled program,
        the way the reference reuses one kernel for any BlockY
        (camera.cl:32, default.go:127-136)."""
        # opt.height is baked into the program (frustum v-interpolation +
        # RNG pixel ids), so it must key the cache like the other statics
        key = ("band", opt.width, opt.height, band_h, opt.spp,
               opt.num_bounces, opt.min_bounces_for_rr, opt.rr_tile_coherent)
        if key in self._jit_cache:
            return self._jit_cache[key]
        W = opt.width
        n = W * band_h
        h_xs, h_ys, _, h_inv = blocked_pixel_order(W, band_h)
        blocked = not np.array_equal(
            h_xs, np.arange(n, dtype=np.int64) % W
        )

        def band_fn(geom, params, frustum, eye, seed, sample_offset, row0):
            S = {**geom, **params}
            xs = jnp.asarray(h_xs)
            ys = jnp.asarray(h_ys).astype(jnp.int32) + row0
            # full-frame pixel index keys the RNG -> band renders are
            # bit-identical to the same rows of a full-frame render
            pixel_idx = ys.astype(jnp.uint32) * W + xs.astype(jnp.uint32)

            def sample_body(s, accum):
                rad = render_sample_block(
                    S,
                    self.closest,
                    self.any_hit,
                    frustum=frustum,
                    eye=eye,
                    width=W,
                    height=opt.height,
                    pixel_x=xs,
                    pixel_y=ys,
                    pixel_idx=pixel_idx,
                    sample_idx=sample_offset + s,
                    seed=seed,
                    num_bounces=opt.num_bounces,
                    min_bounces_for_rr=opt.min_bounces_for_rr,
                    num_emissives=self.num_emissives,
                    scene_diffuse_mat=self.scene_diffuse_mat,
                    material_depth=self.material_depth,
                    rr_tile_coherent=opt.rr_tile_coherent,
                    compact=self.compact,
                    unroll=self.sort_rays,
                )
                return accum + rad

            accum = jax.lax.fori_loop(
                0, opt.spp, sample_body, jnp.zeros((n, 3), jnp.float32)
            )
            if blocked:
                accum = accum[jnp.asarray(h_inv)]
            return accum.reshape(band_h, W, 3)

        fn = jax.jit(band_fn)
        self._jit_cache[key] = fn
        return fn

    def render_band_accum(
        self,
        opt: RenderOptions,
        y0: int,
        band_h: int,
        camera: Optional[Camera] = None,
        sample_offset: int = 0,
    ) -> jnp.ndarray:
        """Render rows [y0, y0+band_h) of the frame; the work unit a
        BlockRequest describes (render/scheduler.py)."""
        if opt.spp > self.spp_per_launch:
            # same chunking as render_accum: one device execution per
            # spp_per_launch samples
            from dataclasses import replace

            total_ms = 0.0
            accum = None
            done = 0
            while done < opt.spp:
                chunk = min(self.spp_per_launch, opt.spp - done)
                part = self.render_band_accum(
                    replace(opt, spp=chunk), y0, band_h, camera=camera,
                    sample_offset=sample_offset + done,
                )
                total_ms += self.last_render_ms
                accum = part if accum is None else accum + part
                done += chunk
            self.last_render_ms = total_ms
            return accum
        cam = camera or Camera.from_scene(self.scene, opt.width, opt.height)
        fn = self._get_band_fn(opt, band_h)
        with Timer() as t:
            accum = fn(
                self.geom,
                self.params,
                jnp.asarray(cam.frustum),
                jnp.asarray(cam.position),
                jnp.uint32(opt.seed),
                jnp.int32(sample_offset),
                jnp.int32(y0),
            )
            accum.block_until_ready()
        self.last_render_ms = t.ms
        return accum

    @staticmethod
    @jax.jit
    def tonemap_u8(accum, sample_weight, exposure):
        """Device-side LDR conversion to uint8.

        Fetching the u8 image moves a quarter of the bytes of the f32
        accumulator, which matters for the per-pass fetch of the
        progressive viewer."""
        img = tonemap_reinhard(jnp, accum, sample_weight, exposure)
        return (jnp.clip(img, 0.0, 1.0) * 255.0).astype(jnp.uint8)

    def render_u8(self, opt: RenderOptions, camera: Optional[Camera] = None):
        """Render and tonemap fully on device; returns [H, W, 3] uint8.

        Chunked frames carry the accumulator on device in blocked lane
        order and finalize (unblock + tonemap + quantize) in one closing
        program; single-launch frames fuse the tonemap into the render
        program itself — either way exactly ONE program touches pixel
        order and the host fetches only the 0.75 MB u8 image."""
        if opt.spp > self.spp_per_launch and not self.batch_samples:
            fin = self._get_finalize_fn(opt.width, opt.height, "u8")
            with Timer() as t:
                accum = self._render_accum_blocked(opt, camera)
                img = fin(
                    accum,
                    jnp.float32(1.0 / opt.spp),
                    jnp.float32(opt.exposure),
                )
                out = np.asarray(img)
            self.last_render_ms = t.ms
            return out
        if opt.spp > self.spp_per_launch:  # batch_samples, chunked
            accum = self.render_accum(opt, camera)
            return np.asarray(
                self.tonemap_u8(
                    accum, jnp.float32(1.0 / opt.spp), jnp.float32(opt.exposure)
                )
            )
        cam = camera or Camera.from_scene(self.scene, opt.width, opt.height)
        fn = self._get_render_fn(opt, emit="u8")
        with Timer() as t:
            img = fn(
                self.geom,
                self.params,
                jnp.asarray(cam.frustum),
                jnp.asarray(cam.position),
                jnp.uint32(opt.seed),
                jnp.int32(0),
            )
            out = np.asarray(img)
        self.last_render_ms = t.ms
        return out
