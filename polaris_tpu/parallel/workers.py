"""Worker-per-backend renderer driven by the feedback block scheduler.

This is the TPU-framework counterpart of the reference's *default renderer*
(renderer/default.go:62-196): one worker thread per backend, an unbuffered
job hand-off per frame, a walking-BlockY row-band split computed by the
scheduler, and per-worker timing fed back so the PerfectScheduler
(tracer/scheduler.go:50-80) rebalances the next frame.

On a homogeneous TPU slice the SPMD mesh (parallel/mesh.py) is the right
tool — one compiled program, psum merge. This pool exists for the
*heterogeneous* case the reference was built around (e.g. a TPU chip plus a
CPU fallback backend, or mixed host types over DCN): backends with different
speeds converge to band heights proportional to measured throughput.

Band renders are bit-identical to the same rows of a full-frame render
because the RNG keys by full-frame pixel id (ops/rng.py), so rebalancing
never changes the image.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from ..render.options import RenderOptions
from ..render.scheduler import NaiveScheduler, PerfectScheduler, blocks_from_heights
from ..render.stats import FrameStats, WorkerFrameStats
from ..utils.log import get_logger

_log = get_logger("worker pool")


class BandWorker:
    """One render backend: a name plus a renderer able to draw row bands.

    ``renderer`` must expose ``render_band_accum(opt, y0, band_h, camera=,
    sample_offset=)`` and ``last_render_ms`` (TpuRenderer does). ``speed``
    seeds the naive first-frame split (≙ the reference's GFlops estimate,
    device.go:209-222).
    """

    def __init__(self, name: str, renderer, speed: float = 1.0):
        self.name = name
        self.renderer = renderer
        self.speed = speed

    def render_band(self, opt: RenderOptions, y0: int, band_h: int,
                    camera=None, sample_offset: int = 0):
        t0 = time.perf_counter()
        accum = np.asarray(
            self.renderer.render_band_accum(
                opt, y0, band_h, camera=camera, sample_offset=sample_offset
            )
        )
        return accum, (time.perf_counter() - t0) * 1e3


def _quantize_heights(heights: Sequence[int], frame_h: int, q: int) -> List[int]:
    """Round band heights to multiples of q (keeps each band's jitted
    program count small — every distinct height is a separate compile,
    unlike the reference's dynamically-sized NDRange launches) while
    preserving the total. Remainder goes to worker 0 (scheduler.go:74-77)."""
    out = [max(0, int(round(h / q)) * q) for h in heights]
    out[0] += frame_h - sum(out)
    if out[0] < 0:
        # pathological estimate: fall back to an equal quantized split
        n = len(heights)
        out = [(frame_h // (n * q)) * q] * n
        out[0] += frame_h - sum(out)
    return out


class WorkerPoolRenderer:
    """Renders frames by fanning row bands out to worker threads.

    Per frame: schedule → parallel band renders → assemble → feed measured
    times back (``renderer/default.go:100-171`` renderFrame). ``frame_stats``
    holds *measured* per-worker telemetry for the CLI table."""

    def __init__(
        self,
        workers: Sequence[BandWorker],
        height_quantum: int = 32,
        use_feedback: bool = True,
    ):
        assert workers, "need at least one worker"
        self.workers = list(workers)
        self.quantum = height_quantum
        self.use_feedback = use_feedback
        self.naive = NaiveScheduler([w.speed for w in self.workers])
        self.perfect = PerfectScheduler(len(self.workers))
        self._frames = 0
        self.frame_stats: Optional[FrameStats] = None

    def schedule(self, frame_h: int) -> List[int]:
        if self.use_feedback and self._frames > 0:
            raw = self.perfect.schedule(frame_h)
        else:
            raw = self.naive.schedule(frame_h)
        return _quantize_heights(raw, frame_h, self.quantum)

    def render_accum(self, opt: RenderOptions, camera=None,
                     sample_offset: int = 0) -> np.ndarray:
        heights = self.schedule(opt.height)
        blocks = blocks_from_heights(heights, opt.width, opt.height,
                                     samples_per_pixel=opt.spp)
        t0 = time.perf_counter()

        def run(i):
            blk = blocks[i]
            if blk.block_h == 0:
                return np.zeros((0, opt.width, 3), np.float32), 0.0
            return self.workers[i].render_band(
                opt, blk.block_y, blk.block_h, camera=camera,
                sample_offset=sample_offset,
            )

        with ThreadPoolExecutor(max_workers=len(self.workers)) as pool:
            results = list(pool.map(run, range(len(self.workers))))
        total_ms = (time.perf_counter() - t0) * 1e3

        stats = FrameStats(total_ms=total_ms)
        for i, (w, blk, (_, ms)) in enumerate(zip(self.workers, blocks, results)):
            stats.workers.append(
                WorkerFrameStats(
                    device_id=w.name,
                    block_w=opt.width,
                    block_h=blk.block_h,
                    render_time_ms=ms,
                )
            )
            # a worker whose quantized share rounded to 0 rows keeps its
            # previous measured rate — reporting (0, 0) would peg its rate
            # at 0.0 and starve it forever (it could only recover through
            # worker 0's remainder)
            if blk.block_h > 0:
                self.perfect.report(i, blk.block_h, ms)
        self.frame_stats = stats.finalize()
        self._frames += 1
        return np.concatenate([band for band, _ in results], axis=0)

    def render(self, opt: RenderOptions, camera=None) -> np.ndarray:
        import jax.numpy as jnp

        from ..render.shade import tonemap_reinhard

        accum = self.render_accum(opt, camera)
        return np.asarray(
            tonemap_reinhard(jnp, jnp.asarray(accum), 1.0 / opt.spp, opt.exposure)
        )


def make_device_pool(scene, mode: str = "auto", devices=None,
                     height_quantum: int = 32) -> WorkerPoolRenderer:
    """One BandWorker per JAX device (each worker's programs pinned to its
    device) — the pool analog of initTracers (default.go:199-292). The
    first frame splits equally; the feedback scheduler then sizes bands
    from measured render times."""
    import jax

    from ..render.integrator import TpuRenderer

    devices = list(devices if devices is not None else jax.devices())
    workers = []
    for d in devices:
        r = TpuRenderer(scene, mode=mode)
        r = _pin_renderer(r, d)
        workers.append(BandWorker(str(d), r))
    return WorkerPoolRenderer(workers, height_quantum=height_quantum)


def _pin_renderer(renderer, device):
    """Route a renderer's band launches to one device via default_device."""
    import jax

    orig = renderer.render_band_accum

    def pinned(*a, **kw):
        with jax.default_device(device):
            return orig(*a, **kw)

    renderer.render_band_accum = pinned
    return renderer
