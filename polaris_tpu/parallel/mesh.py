"""SPMD distribution: tile x sample device mesh via shard_map + psum.

TPU-native replacement for the reference's multi-device machinery
(SURVEY.md §2.3):

  * row-band block scheduling (tracer/scheduler.go:6-106,
    renderer/default.go:127-136)  ->  the 'tile' mesh axis shards image rows
  * per-device goroutine workers + channels (default.go:62-77,174-196)
    ->  one SPMD program; XLA launches per-device executables
  * host-orchestrated accumulator merge onto the primary device
    (aggregateAccumulator, tracer.go:279-286, accumulator.cl:13-19)
    ->  jax.lax.psum over the 'sample' axis (NVLink collective)
  * shared OpenCL context (device/context.go:11-28)  ->  the jax Mesh itself
  * the unimplemented 'Remote' network backend (tracer/tracer.go:52-58)
    ->  multi-host JAX over DCN: the same code runs unchanged on a
    multi-process mesh

Because the RNG is counter-based and keyed on (pixel, sample), the sharded
image is bit-identical to the single-chip image for any mesh shape.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..asset.camera import Camera
from ..asset.scene_data import SceneData
from ..ops.intersect import make_intersectors
from ..render.integrator import blocked_pixel_order, render_sample_block
from ..render.options import RenderOptions
from ..utils.log import Timer, get_logger

_log = get_logger("parallel renderer")

from jax import shard_map


def make_mesh(tile: int, sample: int, devices=None) -> Mesh:
    """Create a (tile, sample) mesh over the given (or all) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size >= tile * sample, (
        f"need {tile * sample} devices, have {devices.size}"
    )
    return Mesh(devices[: tile * sample].reshape(tile, sample), ("tile", "sample"))


class DistributedRenderer:
    """Renders an image sharded over rows ('tile') and samples ('sample')."""

    def __init__(self, scene: SceneData, mesh: Mesh, mode: str = "auto"):
        self.scene = scene
        self.mesh = mesh
        geom, params = scene.split_params()
        self.geom = {
            k: v if k.startswith("_") else jnp.asarray(v) for k, v in geom.items()
        }
        self.params = {k: jnp.asarray(v) for k, v in params.items()}
        self.closest, self.any_hit = make_intersectors(None, scene, mode)
        self.num_emissives = int(scene.emis_area.shape[0])
        self.scene_diffuse_mat = int(scene.scene_diffuse_mat)
        from ..ops.material import material_tree_depth

        self.material_depth = material_tree_depth(
            scene.mat_type, scene.mat_left, scene.mat_right
        )
        self._jit_cache: Dict = {}

    def _block_radiance(self, S, frustum, eye, seed, opt: RenderOptions):
        """Per-device body: render this device's row band for its sample
        shard, then all-reduce over the sample axis."""
        W, H = opt.width, opt.height
        n_tiles = self.mesh.shape["tile"]
        n_samp = self.mesh.shape["sample"]
        rows = H // n_tiles
        spp_local = opt.spp // n_samp

        tile_idx = jax.lax.axis_index("tile")
        samp_idx = jax.lax.axis_index("sample")
        row0 = tile_idx * rows

        n = rows * W
        # lanes walk the band in 32x32 screen blocks (see
        # integrator.blocked_pixel_order) — host constants; row0 is traced
        h_xs, h_ys, _, h_inv = blocked_pixel_order(W, rows)
        blocked = not np.array_equal(h_xs, np.arange(n, dtype=np.int64) % W)
        xs = jnp.asarray(h_xs)
        ys = jnp.asarray(h_ys).astype(jnp.int32) + row0
        # full-frame pixel index keys the RNG -> sharding-invariant image
        pixel_idx = ys.astype(jnp.uint32) * W + xs.astype(jnp.uint32)

        def sample_body(i, accum):
            s = samp_idx * spp_local + i
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
                sample_idx=s,
                seed=seed,
                num_bounces=opt.num_bounces,
                min_bounces_for_rr=opt.min_bounces_for_rr,
                num_emissives=self.num_emissives,
                scene_diffuse_mat=self.scene_diffuse_mat,
                material_depth=self.material_depth,
                rr_tile_coherent=opt.rr_tile_coherent,
            )
            return accum + rad

        accum = jax.lax.fori_loop(
            0, spp_local, sample_body, jnp.zeros((n, 3), jnp.float32)
        )
        # ≙ aggregateAccumulator merge onto the primary (accumulator.cl:13-19)
        accum = jax.lax.psum(accum, "sample")
        if blocked:
            accum = accum[jnp.asarray(h_inv)]
        return accum.reshape(rows, W, 3)

    def _get_render_fn(self, opt: RenderOptions):
        key = (opt.width, opt.height, opt.spp, opt.num_bounces,
               opt.min_bounces_for_rr, opt.rr_tile_coherent)
        if key in self._jit_cache:
            return self._jit_cache[key]
        assert opt.height % self.mesh.shape["tile"] == 0, "rows must divide"
        assert opt.spp % self.mesh.shape["sample"] == 0, "spp must divide"

        def render_fn(geom, params, frustum, eye, seed):
            S = {**geom, **params}
            body = partial(self._block_radiance, opt=opt)
            sharded = shard_map(
                body,
                mesh=self.mesh,
                in_specs=(P(), P(), P(), P()),
                out_specs=P("tile", None, None),
                check_vma=False,
            )
            return sharded(S, frustum, eye, seed)

        fn = jax.jit(render_fn)
        self._jit_cache[key] = fn
        return fn

    def render_accum(self, opt: RenderOptions, camera: Optional[Camera] = None):
        cam = camera or Camera.from_scene(self.scene, opt.width, opt.height)
        fn = self._get_render_fn(opt)
        with Timer() as t:
            out = fn(
                self.geom,
                self.params,
                jnp.asarray(cam.frustum),
                jnp.asarray(cam.position),
                jnp.uint32(opt.seed),
            )
            out.block_until_ready()
        self.last_render_ms = t.ms
        return out

    def render(self, opt: RenderOptions, camera: Optional[Camera] = None):
        from ..render.shade import tonemap_reinhard

        accum = self.render_accum(opt, camera)
        return np.asarray(tonemap_reinhard(jnp, accum, 1.0 / opt.spp, opt.exposure))

    # ----- distributed differentiable training -----

    def make_train_step(self, opt: RenderOptions, lr: float = 0.1):
        """Build a jitted SPMD training step: render -> loss vs target ->
        parameter gradients all-reduced over BOTH mesh axes -> SGD update.

        The gradient psum over ('tile', 'sample') is the renderer's
        equivalent of data-parallel gradient all-reduce riding NVLink
        (SURVEY.md §2.3 'gradient all-reduce overlapped with backward
        shading'); XLA schedules the collective inside the backward pass.
        """
        from ..render.shade import tonemap_reinhard

        # cache per (render config, lr): a real optimization loop calls
        # train_step every iteration and must not re-jit each time
        key = ("train", opt.width, opt.height, opt.spp, opt.num_bounces,
               opt.min_bounces_for_rr, opt.rr_tile_coherent, opt.exposure,
               float(lr))
        if key in self._jit_cache:
            return self._jit_cache[key]

        n_tiles = self.mesh.shape["tile"]
        n_samp = self.mesh.shape["sample"]
        assert opt.height % n_tiles == 0 and opt.spp % n_samp == 0
        rows = opt.height // n_tiles

        def body(params, geom, frustum, eye, seed, target):
            # target arrives row-sharded over 'tile' ([rows, W, 3] here)
            def local_loss(p):
                accum = self._block_radiance(
                    {**geom, **p}, frustum, eye, seed, opt=opt
                )  # includes psum over 'sample'
                img = tonemap_reinhard(
                    jnp, accum + 1e-6, 1.0 / opt.spp, opt.exposure
                )
                return jnp.sum((img - target) ** 2) / (
                    opt.width * opt.height * 3
                )

            # Each sample-shard's grad carries only its own samples'
            # contribution (psum transposes to broadcast), so the full
            # gradient is the plain psum over both axes.
            loss, g = jax.value_and_grad(local_loss)(params)
            loss = jax.lax.psum(loss, "tile")
            g = jax.tree.map(lambda x: jax.lax.psum(x, ("tile", "sample")), g)
            new_params = jax.tree.map(lambda p_, g_: p_ - lr * g_, params, g)
            return loss, new_params

        sharded = shard_map(
            body,
            mesh=self.mesh,
            in_specs=(P(), P(), P(), P(), P(), P("tile", None, None)),
            out_specs=(P(), P()),
            check_vma=False,
        )
        fn = jax.jit(sharded)
        self._jit_cache[key] = fn
        return fn

    def train_step(self, opt: RenderOptions, target, lr: float = 0.1, camera=None):
        """Run one distributed optimization step; updates self.params."""
        cam = camera or Camera.from_scene(self.scene, opt.width, opt.height)
        fn = self.make_train_step(opt, lr)
        loss, new_params = fn(
            self.params,
            self.geom,
            jnp.asarray(cam.frustum),
            jnp.asarray(cam.position),
            jnp.uint32(opt.seed),
            jnp.asarray(target),
        )
        self.params = new_params
        return float(loss)
