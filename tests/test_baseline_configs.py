"""BASELINE config 1 gate at moderate scale with ALL features on:
full bounce count, Russian roulette, MIS NEE — device path vs golden oracle."""

import numpy as np
import pytest

from polaris_tpu.cpu_ref.renderer import CpuRenderer
from polaris_tpu.render.integrator import TpuRenderer
from polaris_tpu.render.options import RenderOptions


@pytest.mark.slow
def test_sphere_full_config_parity(sphere_scene):
    # the BASELINE config-1 recipe (sphere, diffuse + area light) at reduced
    # resolution/spp so the brute-force oracle stays tractable in CI
    opt = RenderOptions(
        width=64, height=64, spp=4, num_bounces=5, min_bounces_for_rr=3
    )
    golden = CpuRenderer(sphere_scene).render_accum(opt)
    got = np.asarray(TpuRenderer(sphere_scene, mode="packet").render_accum(opt))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, golden, atol=2e-4, rtol=1e-3)
    # and the tonemapped image matches byte-for-byte after quantization
    from polaris_tpu.render.shade import tonemap_reinhard

    img_a = (np.clip(tonemap_reinhard(np, golden, 1 / opt.spp, 1.2), 0, 1) * 255).astype(np.uint8)
    img_b = (np.clip(tonemap_reinhard(np, got, 1 / opt.spp, 1.2), 0, 1) * 255).astype(np.uint8)
    assert (img_a == img_b).mean() > 0.999
