"""Edge-avoiding à-trous wavelet denoiser (post-process, beyond the reference).

The reference ships no denoiser; every modern production path tracer does.
This is the classic edge-avoiding à-trous wavelet filter (Dammertz et al.,
HPG 2010): ``iterations`` passes of a 5×5 B3-spline kernel with power-of-two
tap dilation, each tap weighted by color / normal / depth affinity so the
filter smooths Monte-Carlo noise but never crosses geometric edges.

Design notes:

- Pure ``jnp`` elementwise ops over static-shape (H, W, C) images — the 25
  taps per level are edge-padded static slices, so XLA fuses each level into
  one elementwise kernel (no gathers, no dynamic shapes, no matrix units:
  a memory-bandwidth stage that costs little next to the render).
- Fully differentiable (weights are ``exp`` of squared differences), so it
  composes with the inverse-rendering trainer: gradients flow through the
  filter to the radiance estimate.
- The guide pass (:func:`render_guides`) reuses the production traversal
  kernel on pixel-center primary rays (tent filter at u=0.5) and fetches
  vertex normals as flat contiguous rows (the (T, a, b) multi-dim gather is
  the measured ~5 ms trap — see render/shade.py).

Normalization makes the filter mean-preserving on constant regions: for any
weights, ``sum(w·c_q)/sum(w) == c`` when all ``c_q == c`` (to fp rounding),
so a converged (noise-free) flat region passes through unchanged.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

from ..ops import vec as V
from .options import RenderOptions
from .raygen import gen_rays

# 1D B3-spline coefficients; the 2D 5x5 kernel is the separable outer product
# (Dammertz et al. 2010, §3).
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def despeckle(xp, color):
    """Clamp each pixel's luminance to the SECOND-brightest of its 8
    neighbors.

    The à-trous color edge-stop PRESERVES fireflies (their color distance
    to every neighbor is huge, so all cross taps vanish and the outlier
    keeps ~its full value). This is the standard suppression: a 1–2 pixel
    speckle (Russian-roulette boosts often land in adjacent pairs) has at
    most one bright neighbor, so its second-max is background and it drops
    to it; any genuine feature gives each of its pixels >= 2 same-luminance
    neighbors (a 2x2 block has 3) and passes through untouched. Slightly
    biased, like all firefly removal — only applied on the explicit denoise
    path.
    """
    lum = (
        0.2126 * color[..., 0]
        + 0.7152 * color[..., 1]
        + 0.0722 * color[..., 2]
    )
    # pad with -inf, NOT edge-replicate: an edge copy would put a border
    # pixel's own luminance into its neighborhood, so corner fireflies
    # (3 self-copies) and border speckle pairs would never clamp
    lp = xp.pad(lum, ((1, 1), (1, 1)), mode="constant",
                constant_values=-xp.inf)
    H, W = lum.shape
    max1 = None  # brightest REAL neighbor (OOB taps are -inf, never win)
    max2 = None  # second-brightest real neighbor
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            s = lp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            if max1 is None:
                max1, max2 = s, xp.full_like(s, -xp.inf)
            else:
                max2 = xp.maximum(max2, xp.minimum(max1, s))
                max1 = xp.maximum(max1, s)
    scale = xp.where(lum > max2, max2 / xp.maximum(lum, 1e-20), 1.0)
    return color * scale[..., None]


def atrous_denoise(
    xp,
    color,
    normal,
    depth,
    *,
    iterations: int = 4,
    c_phi: float = 0.4,
    n_phi: float = 0.25,
    d_phi: float = 0.05,
):
    """Filter an (H, W, 3) radiance image guided by per-pixel normal + depth.

    Args:
      color: (H, W, 3) mean radiance (HDR, pre-tonemap).
      normal: (H, W, 3) world-space shading normals (0 where no hit).
      depth: (H, W) normalized hit distance in [0, 1] (1.0 where no hit).
      iterations: à-trous levels; level i uses tap spacing 2**i, so 4 levels
        give a 33-pixel effective footprint.
      c_phi / n_phi / d_phi: edge-stopping bandwidths for color, normal and
        depth differences. ``c_phi`` is halved each level (coarser levels
        trust the progressively smoothed color more), per the paper.

    Returns the filtered (H, W, 3) image; flat regions pass through
    unchanged (to fp rounding).
    """
    out = color
    for it in range(iterations):
        out = _atrous_level(
            xp, out, normal, depth,
            step=1 << it,
            c_phi=c_phi * (0.5 ** it),
            n_phi=n_phi,
            d_phi=d_phi,
        )
    return out


def _atrous_level(xp, color, normal, depth, *, step, c_phi, n_phi, d_phi):
    H, W = color.shape[0], color.shape[1]
    R = 2 * step
    # edge padding keeps every tap in-bounds with static slices (no gathers)
    cp = xp.pad(color, ((R, R), (R, R), (0, 0)), mode="edge")
    np_ = xp.pad(normal, ((R, R), (R, R), (0, 0)), mode="edge")
    dp = xp.pad(depth, ((R, R), (R, R)), mode="edge")

    inv_c2 = 1.0 / (c_phi * c_phi)
    inv_n2 = 1.0 / (n_phi * n_phi)
    inv_d2 = 1.0 / (d_phi * d_phi)

    acc = xp.zeros_like(color)
    wsum = xp.zeros(color.shape[:2], color.dtype)
    for j in range(5):
        dy = (j - 2) * step
        for i in range(5):
            dx = (i - 2) * step
            h = _B3[j] * _B3[i]
            cq = cp[R + dy:R + dy + H, R + dx:R + dx + W, :]
            nq = np_[R + dy:R + dy + H, R + dx:R + dx + W, :]
            dq = dp[R + dy:R + dy + H, R + dx:R + dx + W]
            dc = color - cq
            dn = normal - nq
            dd = depth - dq
            w = h * xp.exp(
                -(xp.sum(dc * dc, axis=-1) * inv_c2
                  + xp.sum(dn * dn, axis=-1) * inv_n2
                  + dd * dd * inv_d2)
            )
            acc = acc + w[..., None] * cq
            wsum = wsum + w
    # wsum >= the center tap's (3/8)^2 (all three distances are 0 there)
    return acc / wsum[..., None]


def render_guides(
    renderer, opt: RenderOptions, camera=None
) -> Tuple[np.ndarray, np.ndarray]:
    """One primary-ray pass producing the denoiser's geometric guides.

    Rays go through pixel CENTERS (the tent filter maps u=0.5 to offset 0.5)
    so the guides are deterministic and seed-independent. Returns
    ``(normal (H, W, 3) float32, depth (H, W) float32)``; lanes that miss
    get normal 0 and depth 1.0, so background pixels smooth among themselves
    but never bleed across the silhouette (the normal term kills those taps).
    """
    import jax
    import jax
    import jax.numpy as jnp

    from ..asset.camera import Camera

    scene = renderer.scene
    cam = camera or Camera.from_scene(scene, opt.width, opt.height)
    Wd, Hd = opt.width, opt.height

    # cache the jitted program PER RENDERER + frame shape: a fresh closure
    # per call would retrace and recompile the traversal every frame. The scene
    # travels as jit ARGUMENTS (like integrator's render fns), not closure
    # constants — constants would bloat the traced program with the whole
    # BVH/vertex tables and go stale when the trainer swaps renderer.params.
    cache = getattr(renderer, "_guide_fn_cache", None)
    if cache is None:
        cache = renderer._guide_fn_cache = {}
    run = cache.get((Wd, Hd))
    if run is None:
        n = Wd * Hd

        @jax.jit
        def run(geom, params, frustum, eye):
            S = {**geom, **params}
            pixel_idx = jnp.arange(n, dtype=jnp.uint32)
            xs = (pixel_idx % Wd).astype(jnp.int32)
            ys = (pixel_idx // Wd).astype(jnp.int32)
            U_center = lambda stream: jnp.full((n,), 0.5, jnp.float32)
            o, d = gen_rays(jnp, frustum, eye, Wd, Hd, xs, ys, U_center)
            hit = renderer.closest(
                S, o, d, jnp.full(n, V.FLT_MAX), jnp.ones(n, bool)
            )
            # flat-row vertex-normal fetch (shade.py: multi-dim gather trap)
            tn = S["tri_normals"].reshape(-1, 9)[hit.tri]
            w = 1.0 - hit.u - hit.v
            n_obj = (
                w[..., None] * tn[..., 0:3]
                + hit.u[..., None] * tn[..., 3:6]
                + hit.v[..., None] * tn[..., 6:9]
            )
            w2o = V.take_small(jnp, S["inst_w2o"], hit.inst)
            nw = V.normalize3(jnp, V.transform_normal(jnp, w2o, n_obj))
            nrm = jnp.where(hit.mask[..., None], nw, 0.0)
            t = jnp.where(hit.mask, hit.t, 0.0)
            tmax = jnp.maximum(jnp.max(t), 1e-6)
            z = jnp.where(hit.mask, t / tmax, 1.0)
            return nrm.reshape(Hd, Wd, 3), z.reshape(Hd, Wd)

        cache[(Wd, Hd)] = run

    nrm, z = run(
        renderer.geom, renderer.params,
        jnp.asarray(cam.frustum), jnp.asarray(cam.position),
    )
    return np.asarray(nrm, np.float32), np.asarray(z, np.float32)


def denoise_accum(
    renderer,
    opt: RenderOptions,
    accum: np.ndarray,
    accumulated_samples: int,
    camera=None,
    *,
    iterations: int = 4,
    c_phi: float = 0.4,
    n_phi: float = 0.25,
    d_phi: float = 0.05,
    suppress_fireflies: bool = True,
) -> np.ndarray:
    """Denoise an HDR accumulator, returning it at the SAME scale (sum of
    samples, not mean) so downstream tonemap stages keep dividing by the
    sample count unchanged.

    The whole filter (despeckle + every à-trous level) runs as ONE jitted
    program — eager per-op dispatch would pay one launch per op, hundreds
    of them; fused it is a single cheap elementwise kernel chain.
    """
    import jax.numpy as jnp

    ns = max(int(accumulated_samples), 1)
    nrm, z = render_guides(renderer, opt, camera)
    out = _get_filter_fn()(
        jnp.asarray(accum), jnp.float32(ns), jnp.asarray(nrm), jnp.asarray(z),
        jnp.float32(c_phi), jnp.float32(n_phi), jnp.float32(d_phi),
        iters=iterations, fireflies=suppress_fireflies,
    )
    return np.asarray(out, np.float32)


_FILTER_FN = None


def _get_filter_fn():
    """The jitted despeckle + à-trous program, cached at module scope so
    repeated calls reuse the compiled executable (jit caches per function
    OBJECT — a per-call closure recompiles every frame)."""
    global _FILTER_FN
    if _FILTER_FN is None:
        import jax
        import jax.numpy as jnp

        @partial(jax.jit, static_argnames=("iters", "fireflies"))
        def run(acc, samples, nrm, z, cp, np_, dp, iters, fireflies):
            mean = acc.astype(jnp.float32) / samples
            if fireflies:
                mean = despeckle(jnp, mean)
            return atrous_denoise(
                jnp, mean, nrm, z,
                iterations=iters, c_phi=cp, n_phi=np_, d_phi=dp,
            ) * samples

        _FILTER_FN = run
    return _FILTER_FN
