"""Forward-image parity: the device integrator (every traversal mode) vs the
NumPy golden renderer. This is the allclose gate the reference never had
(SURVEY.md §4 'no numerical ground truth')."""

import numpy as np
import pytest

from polaris_tpu.cpu_ref.renderer import CpuRenderer
from polaris_tpu.render.integrator import TpuRenderer
from polaris_tpu.render.options import RenderOptions


def _compare(scene, opt, modes=("bvh", "brute"), atol=1e-4):
    golden = CpuRenderer(scene).render_accum(opt)
    assert np.isfinite(golden).all()
    for mode in modes:
        got = np.asarray(TpuRenderer(scene, mode=mode).render_accum(opt))
        assert np.isfinite(got).all(), mode
        np.testing.assert_allclose(got, golden, atol=atol, rtol=1e-3, err_msg=mode)


def test_cornell_parity(cornell_scene):
    opt = RenderOptions(width=48, height=48, spp=2, num_bounces=3, min_bounces_for_rr=4)
    _compare(cornell_scene, opt)


def test_cornell_with_rr_parity(cornell_scene):
    opt = RenderOptions(width=32, height=32, spp=2, num_bounces=4, min_bounces_for_rr=2)
    _compare(cornell_scene, opt, modes=("bvh",))


def test_sphere_parity(sphere_scene):
    opt = RenderOptions(width=32, height=32, spp=2, num_bounces=2, min_bounces_for_rr=3)
    _compare(sphere_scene, opt)


@pytest.fixture(scope="module")
def _scene(scenes_dir):
    import os

    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene

    def load(name):
        return compile_scene(read_scene(os.path.join(scenes_dir, f"{name}.obj")))

    return load


def test_mitsuba_parity(_scene):
    """BASELINE config 3: roughConductor/roughDielectric + textures."""
    opt = RenderOptions(width=24, height=24, spp=2, num_bounces=3, min_bounces_for_rr=4)
    _compare(_scene("mitsuba"), opt, modes=("bvh",), atol=2e-4)


def test_instanced_parity(_scene):
    """BASELINE config 4: two-level BVH with transformed instances."""
    opt = RenderOptions(width=24, height=24, spp=2, num_bounces=2, min_bounces_for_rr=3)
    _compare(_scene("instanced"), opt, modes=("bvh", "packet"))


def test_dispersive_parity(_scene):
    """BASELINE config 5: dispersive dielectric + HDR env map."""
    opt = RenderOptions(width=24, height=24, spp=2, num_bounces=3, min_bounces_for_rr=4)
    _compare(_scene("dispersive"), opt, modes=("bvh",), atol=2e-4)


def test_pallas_parity(cornell_scene):
    """The Pallas traversal kernel (interpret mode on CPU) against the
    golden renderer."""
    opt = RenderOptions(width=32, height=32, spp=1, num_bounces=2, min_bounces_for_rr=3)
    _compare(cornell_scene, opt, modes=("pallas",))


def test_image_nonblack(cornell_scene):
    opt = RenderOptions(width=32, height=32, spp=1, num_bounces=3, min_bounces_for_rr=4)
    img = TpuRenderer(cornell_scene, mode="bvh").render(opt)
    assert img.mean() > 0.05
    assert img.max() <= 1.0


def test_tile_coherent_rr_parity(cornell_scene):
    """Tile-coherent Russian roulette (rr_tile_coherent): blocks draw one
    survival uniform, lanes keep their own survival probability and boost —
    unbiased, and the oracle (which shares shade() and the RNG layout) must
    agree exactly. Also checks it actually changes the RR pattern."""
    opt = RenderOptions(
        width=32, height=32, spp=2, num_bounces=4, min_bounces_for_rr=1,
        rr_tile_coherent=True,
    )
    _compare(cornell_scene, opt, modes=("bvh", "pallas"))
    base = RenderOptions(
        width=32, height=32, spp=2, num_bounces=4, min_bounces_for_rr=1,
    )
    a = np.asarray(TpuRenderer(cornell_scene, mode="bvh").render_accum(base))
    b = np.asarray(TpuRenderer(cornell_scene, mode="bvh").render_accum(opt))
    assert not np.array_equal(a, b)  # the mode is live, not a no-op
