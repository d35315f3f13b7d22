"""Wavefront path regeneration (render_block_regen): estimator equivalence.

The regen integrator replays EXACTLY the sequential integrator's paths —
every draw keys by (pixel, sample, bounce, stream) — so its accumulator
equals the sequential one up to float accumulation order (contributions
stream in per-lane chronological order instead of per-sample partial
sums). These tests pin that equivalence across scenes, traversal modes,
chunking, and the CLI flag. Parity with the CPU oracle follows
transitively from tests/test_parity.py on the sequential path.
"""

import numpy as np
import pytest

from polaris_tpu.render.integrator import TpuRenderer
from polaris_tpu.render.options import RenderOptions


def _opt(**kw):
    base = dict(width=32, height=32, spp=4, num_bounces=3,
                min_bounces_for_rr=2)
    base.update(kw)
    return RenderOptions(**base)


@pytest.mark.parametrize("mode", ["bvh", "pallas"])
def test_regen_matches_sequential(cornell_scene, mode):
    opt = _opt()
    seq = np.asarray(TpuRenderer(cornell_scene, mode=mode).render_accum(opt))
    reg = np.asarray(
        TpuRenderer(cornell_scene, mode=mode, regen=True).render_accum(opt)
    )
    np.testing.assert_allclose(reg, seq, rtol=2e-5, atol=2e-5)


def test_regen_matches_sequential_background_misses(sphere_scene):
    """Misses + env shading: per-lane is_primary flags in shade_miss."""
    opt = _opt(num_bounces=4)
    seq = np.asarray(TpuRenderer(sphere_scene, mode="bvh").render_accum(opt))
    reg = np.asarray(
        TpuRenderer(sphere_scene, mode="bvh", regen=True).render_accum(opt)
    )
    np.testing.assert_allclose(reg, seq, rtol=2e-5, atol=2e-5)


def test_regen_chunked_carry(cornell_scene):
    """Chunked regen (blocked-order accumulator carry) == one-shot regen ==
    sequential, and the u8 finalize path agrees."""
    opt = _opt(spp=6)
    r = TpuRenderer(cornell_scene, mode="bvh", regen=True)
    r.spp_per_launch = 2
    chunked = np.asarray(r.render_accum(opt))
    r2 = TpuRenderer(cornell_scene, mode="bvh", regen=True)
    r2.spp_per_launch = 99
    whole = np.asarray(r2.render_accum(opt))
    np.testing.assert_allclose(chunked, whole, rtol=2e-5, atol=2e-5)
    seq = np.asarray(TpuRenderer(cornell_scene, mode="bvh").render_accum(opt))
    np.testing.assert_allclose(chunked, seq, rtol=2e-5, atol=2e-5)
    u8c = r.render_u8(opt)
    u8w = r2.render_u8(opt)
    # tonemap compresses association noise below quantization on all but
    # knife-edge texels; allow the odd off-by-one level
    assert np.abs(u8c.astype(int) - u8w.astype(int)).max() <= 1


def test_regen_rr_and_offsets(cornell_scene):
    """RR active (per-lane bounce >= threshold compares) + absolute sample
    offsets (progressive restart) both key the same draws."""
    opt = _opt(spp=2, num_bounces=4, min_bounces_for_rr=1)
    seq = np.asarray(TpuRenderer(cornell_scene, mode="bvh").render_accum(opt))
    reg = np.asarray(
        TpuRenderer(cornell_scene, mode="bvh", regen=True).render_accum(opt)
    )
    np.testing.assert_allclose(reg, seq, rtol=2e-5, atol=2e-5)
    # offset renders: samples [2,4) via the offset API
    r = TpuRenderer(cornell_scene, mode="bvh", regen=True)
    part = np.asarray(r.render_accum_offset(opt, sample_offset=2))
    rs = TpuRenderer(cornell_scene, mode="bvh")
    part_seq = np.asarray(rs.render_accum_offset(opt, sample_offset=2))
    np.testing.assert_allclose(part, part_seq, rtol=2e-5, atol=2e-5)


def test_regen_flag_sanitized(cornell_scene):
    """regen is an execution strategy for the plain integrator only; the
    ctor drops it when combined with the special lane-layout modes
    (compact permutes lanes per bounce); every traversal mode keeps it."""
    r = TpuRenderer(cornell_scene, mode="bvh", regen=True, compact=True)
    assert r.regen is False
    r = TpuRenderer(cornell_scene, mode="bvh", regen=True)
    assert r.regen is True
    r = TpuRenderer(cornell_scene, mode="pallas", regen=True)
    assert r.regen is True
