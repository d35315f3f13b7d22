"""Adaptive per-block sampling (round-4 VERDICT weak #3).

The lockstep replacement for the reference's in-kernel compaction queues
(pt_integrator.cl:49-64): converged 32x32 blocks stop drawing samples, and
their inactive lanes skip traversal. The RNG's
absolute sample indices make the result exactly reproducible per block.
"""

import numpy as np
import pytest

from polaris_tpu.render.integrator import TILE_LANES, TpuRenderer, blocked_pixel_order
from polaris_tpu.render.options import RenderOptions


def test_adaptive_budget_matches_uniform(cornell_scene):
    """With tol=0 no block ever converges: the adaptive render must equal
    the plain fixed-spp render bit-for-bit (same per-sample add order)."""
    opt = RenderOptions(width=64, height=64, spp=4, num_bounces=2,
                        min_bounces_for_rr=3)
    r = TpuRenderer(cornell_scene, mode="bvh")
    uniform = np.asarray(r.render_accum(opt))
    accum, spp_map = r.render_adaptive(opt, tol=0.0, chunk=4)
    assert (spp_map == 4).all()
    np.testing.assert_array_equal(accum, uniform)


def test_adaptive_blocks_stop_and_reproduce(cornell_scene):
    """Blocks that stop early must hold EXACTLY the accumulator of a plain
    render with that block's sample count (absolute RNG indices), and a
    noisy scene at a loose tolerance must actually stop some blocks."""
    opt = RenderOptions(width=64, height=64, spp=16, num_bounces=2,
                        min_bounces_for_rr=3)
    r = TpuRenderer(cornell_scene, mode="bvh")
    accum, spp_map = r.render_adaptive(opt, tol=0.25, chunk=4, min_spp=4)
    counts = np.unique(spp_map)
    assert counts.min() >= 4 and counts.max() <= 16
    assert counts.size > 1, "tolerance 0.25 should stop some blocks early"
    # reproducibility: for every distinct count, a fixed-spp render of that
    # count matches the adaptive accumulator on exactly those pixels
    # (single-launch render: the adaptive carry adds sample-by-sample, so
    # it is bit-identical to one uninterrupted fori_loop over c samples)
    from dataclasses import replace

    for c in counts:
        fixed = np.asarray(r.render_accum_offset(replace(opt, spp=int(c))))
        sel = spp_map == c
        np.testing.assert_array_equal(accum[sel], fixed[sel])


def test_adaptive_spp_map_block_structure(cornell_scene):
    """The spp map is constant over each 32x32 block (the stop unit)."""
    opt = RenderOptions(width=64, height=64, spp=8, num_bounces=2,
                        min_bounces_for_rr=3)
    r = TpuRenderer(cornell_scene, mode="bvh")
    _, spp_map = r.render_adaptive(opt, tol=0.3, chunk=4, min_spp=4)
    xs, ys, pix, inv = blocked_pixel_order(64, 64)
    lane_spp = spp_map.reshape(-1)[pix]  # lane order
    blocks = lane_spp.reshape(-1, TILE_LANES)
    assert (blocks == blocks[:, :1]).all()


def test_adaptive_u8_weighting(cornell_scene):
    """Per-pixel sample weights: a block stopped at n samples is tonemapped
    with 1/n, so brightness is unbiased vs the uniform image."""
    opt = RenderOptions(width=64, height=64, spp=16, num_bounces=2,
                        min_bounces_for_rr=3)
    r = TpuRenderer(cornell_scene, mode="bvh")
    img, spp_map = r.render_adaptive_u8(opt, tol=0.2, chunk=4, min_spp=4)
    assert img.dtype == np.uint8 and img.shape == (64, 64, 3)
    ref = (np.clip(r.render(opt), 0, 1) * 255 + 0.5).astype(np.uint8)
    # adaptive differs only by estimator noise in stopped blocks; the mean
    # byte difference stays small if weighting is correct (a 1/spp bug
    # would scale whole blocks by 2-4x)
    assert np.abs(img.astype(int) - ref.astype(int)).mean() < 2.0


def test_adaptive_budget_cap_non_multiple(cornell_scene):
    """opt.spp is a hard budget CAP even when not a multiple of the chunk
    size (review finding: the loop used to add a full chunk past it)."""
    opt = RenderOptions(width=64, height=64, spp=10, num_bounces=2,
                        min_bounces_for_rr=3)
    r = TpuRenderer(cornell_scene, mode="bvh")
    accum, spp_map = r.render_adaptive(opt, tol=0.0, chunk=4)
    assert spp_map.max() == 10
    fixed = np.asarray(r.render_accum_offset(opt))
    np.testing.assert_array_equal(accum, fixed)
