"""Worker-pool renderer + feedback scheduler wiring.

Mirrors the reference's scheduler tests (tracer/scheduler_test.go:8-123):
fake workers with synthetic speeds prove the PerfectScheduler feedback loop
converges band heights to measured throughput, and real TpuRenderer workers
prove band assembly is bit-identical to a single full-frame render.
"""

import numpy as np
import pytest

from polaris_tpu.parallel.workers import (
    BandWorker,
    WorkerPoolRenderer,
    make_device_pool,
)
from polaris_tpu.render.integrator import TpuRenderer
from polaris_tpu.render.options import RenderOptions


class FakeRenderer:
    """Mock-tracer pattern: render time proportional to rows / speed."""

    def __init__(self, speed: float):
        self.speed = speed
        self.last_render_ms = 0.0

    def render_band_accum(self, opt, y0, band_h, camera=None, sample_offset=0):
        self.last_render_ms = band_h / self.speed
        return np.full((band_h, opt.width, 3), float(y0), np.float32)


class FakeWorker(BandWorker):
    """BandWorker whose reported time is the fake renderer's synthetic time
    (wall time of a zeros-fill would be meaningless)."""

    def render_band(self, opt, y0, band_h, camera=None, sample_offset=0):
        accum = np.asarray(
            self.renderer.render_band_accum(opt, y0, band_h)
        )
        return accum, self.renderer.last_render_ms


def test_feedback_converges_to_throughput():
    # worker 1 is 3x faster; after feedback it should get ~3x the rows
    workers = [FakeWorker("slow", FakeRenderer(1.0)),
               FakeWorker("fast", FakeRenderer(3.0))]
    pool = WorkerPoolRenderer(workers, height_quantum=16)
    opt = RenderOptions(width=32, height=256, spp=1, num_bounces=1)
    for _ in range(4):
        pool.render_accum(opt)
    heights = pool.schedule(opt.height)
    assert sum(heights) == 256
    assert heights[1] > 2.0 * heights[0], heights


def test_naive_first_frame_uses_speed_estimates():
    workers = [FakeWorker("a", FakeRenderer(1.0), speed=1.0),
               FakeWorker("b", FakeRenderer(1.0), speed=2.0)]
    pool = WorkerPoolRenderer(workers, height_quantum=16)
    heights = pool.schedule(96)
    # naive split 1:2 (scheduler.go:83-106), quantized to 16 rows
    assert heights == [32, 64]


def test_band_render_matches_full_frame_rows(cornell_scene):
    opt = RenderOptions(width=32, height=32, spp=2, num_bounces=2)
    r = TpuRenderer(cornell_scene, mode="bvh")
    full = np.asarray(r.render_accum(opt))
    band = np.asarray(r.render_band_accum(opt, y0=8, band_h=16))
    np.testing.assert_array_equal(band, full[8:24])


def test_pool_image_bit_identical_and_stats_real(cornell_scene):
    opt = RenderOptions(width=32, height=32, spp=2, num_bounces=2)
    single = np.asarray(TpuRenderer(cornell_scene, mode="bvh").render_accum(opt))

    workers = [
        BandWorker("w0", TpuRenderer(cornell_scene, mode="bvh")),
        BandWorker("w1", TpuRenderer(cornell_scene, mode="bvh")),
    ]
    pool = WorkerPoolRenderer(workers, height_quantum=16)
    accum = pool.render_accum(opt)
    np.testing.assert_array_equal(accum, single)

    stats = pool.frame_stats
    assert len(stats.workers) == 2
    assert sum(w.block_h for w in stats.workers) == 32
    # measured, not fabricated: every worker reports its own wall time
    assert all(w.render_time_ms > 0 for w in stats.workers)
    assert abs(sum(w.frame_percent for w in stats.workers) - 100.0) < 1e-6


def test_device_pool_runs_on_virtual_mesh(cornell_scene):
    import jax

    opt = RenderOptions(width=32, height=32, spp=1, num_bounces=1)
    pool = make_device_pool(cornell_scene, mode="bvh",
                            devices=jax.devices()[:2], height_quantum=16)
    img = pool.render(opt)
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()


def test_zero_height_worker_is_not_starved():
    """A worker whose quantized share rounds to 0 rows must keep its last
    measured rate (reporting 0/0 would peg it at rate 0.0 forever)."""
    # worker 1 is 50x slower: its proportional share of 128 rows (~2.5)
    # quantizes to 0 after the first measured frame
    workers = [FakeWorker("fast", FakeRenderer(50.0)),
               FakeWorker("slow", FakeRenderer(1.0))]
    pool = WorkerPoolRenderer(workers, height_quantum=32)
    opt = RenderOptions(width=16, height=128, spp=1, num_bounces=1)
    for _ in range(5):
        pool.render_accum(opt)
    # the slow worker's last MEASURED stats must be retained, not 0/0 —
    # so if the fast worker degrades, the slow one can win rows back
    st = pool.perfect.last[1]
    assert st.block_h > 0 and st.render_time_ms > 0, st
    workers[0].renderer.speed = 0.5  # fast worker degrades 100x
    for _ in range(3):
        pool.render_accum(opt)
    heights = pool.schedule(opt.height)
    assert heights[1] > 0, heights  # recovered rows


def test_band_jit_cache_keys_frame_height(cornell_scene):
    """Same (width, band_h) at two frame heights must not share a program
    (frame height is baked into frustum interpolation + RNG pixel ids)."""
    r = TpuRenderer(cornell_scene, mode="bvh")
    opt64 = RenderOptions(width=16, height=64, spp=1, num_bounces=2, min_bounces_for_rr=3)
    opt32 = RenderOptions(width=16, height=32, spp=1, num_bounces=2, min_bounces_for_rr=3)
    band64 = np.asarray(r.render_band_accum(opt64, 16, 16))
    band32 = np.asarray(r.render_band_accum(opt32, 16, 16))
    full64 = np.asarray(TpuRenderer(cornell_scene, mode="bvh").render_accum(opt64))
    full32 = np.asarray(TpuRenderer(cornell_scene, mode="bvh").render_accum(opt32))
    np.testing.assert_array_equal(band64, full64[16:32])
    np.testing.assert_array_equal(band32, full32[16:32])


def test_band_spp_chunking_matches_single_launch(cornell_scene):
    """Band renders must chunk spp by spp_per_launch and stay
    bit-identical to an unchunked band."""
    opt = RenderOptions(width=16, height=32, spp=6, num_bounces=2, min_bounces_for_rr=3)
    r1 = TpuRenderer(cornell_scene, mode="bvh")
    r1.spp_per_launch = 2
    chunked = np.asarray(r1.render_band_accum(opt, 8, 16))
    r2 = TpuRenderer(cornell_scene, mode="bvh")
    r2.spp_per_launch = 99
    whole = np.asarray(r2.render_band_accum(opt, 8, 16))
    np.testing.assert_allclose(chunked, whole, atol=1e-5)
