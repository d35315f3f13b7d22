"""Differentiable-rendering tests: autodiff vs finite differences.

BASELINE gate: 'pixel-gradient parity vs finite differences' (SURVEY.md §7).
The RNG is seed-deterministic, so finite differences of the full estimator
are well-defined as long as the perturbation doesn't flip a discrete draw.
"""

import numpy as np
import pytest

from polaris_tpu.render.grad import DifferentiableRenderer
from polaris_tpu.render.options import RenderOptions


@pytest.fixture(scope="module")
def opt():
    return RenderOptions(width=24, height=24, spp=2, num_bounces=2, min_bounces_for_rr=3)


def _loss(r, opt, params, target):
    import jax.numpy as jnp

    from polaris_tpu.render.shade import tonemap_reinhard

    accum = np.asarray(r.render_from_params(opt, params))
    img = tonemap_reinhard(np, accum + 1e-6, 1.0 / opt.spp, opt.exposure)
    return float(np.mean((img - target) ** 2))


def test_grads_exist_and_finite(cornell_scene, opt):
    r = DifferentiableRenderer(cornell_scene, mode="bvh")
    target = np.zeros((opt.height, opt.width, 3), np.float32)
    loss, g_params, g_cam = r.loss_and_grad(opt, target)
    assert np.isfinite(loss) and loss > 0
    # some gradient must reach the diffuse reflectances and the camera
    assert np.isfinite(g_params["mat_reflectance"]).all()
    assert np.abs(g_params["mat_reflectance"]).max() > 0
    assert np.isfinite(g_params["mat_radiance"]).all()
    assert np.abs(g_params["mat_radiance"]).max() > 0
    assert np.isfinite(g_cam["eye"]).all()
    assert np.abs(g_cam["eye"]).max() > 0


def test_grad_matches_finite_difference(cornell_scene, opt):
    import jax.numpy as jnp

    r = DifferentiableRenderer(cornell_scene, mode="bvh")
    target = np.zeros((opt.height, opt.width, 3), np.float32)
    loss0, g_params, _ = r.loss_and_grad(opt, target)

    # perturb one diffuse material's red reflectance
    mats = np.asarray(r.params["mat_reflectance"]).copy()
    m = int(np.abs(np.asarray(g_params["mat_reflectance"])).sum(axis=1).argmax())
    eps = 2e-3
    p_plus = dict(r.params)
    mp = mats.copy()
    mp[m, 0] += eps
    p_plus["mat_reflectance"] = jnp.asarray(mp)
    p_minus = dict(r.params)
    mm = mats.copy()
    mm[m, 0] -= eps
    p_minus["mat_reflectance"] = jnp.asarray(mm)

    fd = (_loss(r, opt, p_plus, target) - _loss(r, opt, p_minus, target)) / (2 * eps)
    ad = float(np.asarray(g_params["mat_reflectance"])[m, 0])
    assert fd != 0.0
    assert abs(fd - ad) / (abs(fd) + 1e-8) < 0.08, (fd, ad)


def test_grads_through_pallas_traversal(cornell_scene, opt):
    """The production path on the GPU is mode='auto' -> the Pallas
    traversal kernel under jax.grad. Run it in interpret mode and require agreement with the
    bvh-mode gradients: traversal is gradient-stopped on both sides
    (integrator.py:257-263), so the backward programs are identical and the
    only differences are forward-value ulps in the intersection results."""
    target = np.zeros((opt.height, opt.width, 3), np.float32)
    r_p = DifferentiableRenderer(cornell_scene, mode="pallas")
    loss_p, gp, gcp = r_p.loss_and_grad(opt, target)
    assert np.isfinite(loss_p) and loss_p > 0
    for k, v in gp.items():
        assert np.isfinite(v).all(), k
    assert np.abs(gp["mat_reflectance"]).max() > 0
    assert np.isfinite(gcp["eye"]).all() and np.abs(gcp["eye"]).max() > 0

    r_b = DifferentiableRenderer(cornell_scene, mode="bvh")
    loss_b, gb, gcb = r_b.loss_and_grad(opt, target)
    np.testing.assert_allclose(loss_p, loss_b, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(gp["mat_reflectance"]),
        np.asarray(gb["mat_reflectance"]),
        rtol=5e-3,
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(gcp["eye"]), np.asarray(gcb["eye"]), rtol=5e-3, atol=1e-6
    )


def test_texture_atlas_gradient_fd(textured_scene, opt):
    """BASELINE north star: gradients flow to TEXTURES — FD-verified on a
    textured scene (round-2 VERDICT weak #3: tex_data gradients were claimed
    but never tested; on texture-free scenes ops/statics.py prunes the
    texture branches entirely, so the old tests could pass with silently-zero
    atlas gradients)."""
    import jax.numpy as jnp

    r = DifferentiableRenderer(textured_scene, mode="bvh")
    target = np.zeros((opt.height, opt.width, 3), np.float32)
    loss0, g_params, _ = r.loss_and_grad(opt, target)
    gtex = np.asarray(g_params["tex_data"])
    assert np.isfinite(gtex).all()
    assert np.abs(gtex).max() > 0, "no gradient reached the texture atlas"

    # FD on the texel with the largest gradient (bilinear sampling is linear
    # in the texel values, so FD is clean: no discrete draw can flip)
    i = int(np.abs(gtex).argmax())
    atlas = np.asarray(r.params["tex_data"]).copy()
    eps = 2e-3
    p_plus = dict(r.params)
    ap = atlas.copy()
    ap[i] += eps
    p_plus["tex_data"] = jnp.asarray(ap)
    p_minus = dict(r.params)
    am = atlas.copy()
    am[i] -= eps
    p_minus["tex_data"] = jnp.asarray(am)
    fd = (_loss(r, opt, p_plus, target) - _loss(r, opt, p_minus, target)) / (2 * eps)
    ad = float(gtex[i])
    assert fd != 0.0
    assert abs(fd - ad) / (abs(fd) + 1e-8) < 0.08, (fd, ad)


def test_roughness_and_ior_leaf_gradient_fd(textured_scene):
    """Roughness and IOR leaf gradients, FD-verified. num_bounces=1 keeps the
    estimator's roughness dependence entirely in the continuous NEE
    eval/pdf/MIS terms (no indirect traversal re-hit in the FD), so autodiff
    (which gradient-stops traversal) and FD agree tightly."""
    import jax.numpy as jnp

    opt1 = RenderOptions(
        width=24, height=24, spp=2, num_bounces=1, min_bounces_for_rr=3
    )
    r = DifferentiableRenderer(textured_scene, mode="bvh")
    target = np.zeros((opt1.height, opt1.width, 3), np.float32)
    _, g_params, _ = r.loss_and_grad(opt1, target)
    rough_row = int(
        np.abs(np.asarray(g_params["mat_roughness"])).argmax()
    )

    for fieldname, row, eps, col in (
        ("mat_roughness", rough_row, 2e-3, None),
        ("mat_int_ior", rough_row, 4e-3, None),
    ):
        g = np.asarray(g_params[fieldname])
        assert np.isfinite(g).all(), fieldname
        ad = float(g[row])
        assert ad != 0.0, f"zero gradient for {fieldname}"
        vals = np.asarray(r.params[fieldname]).copy()
        p_plus = dict(r.params)
        vp = vals.copy()
        vp[row] += eps
        p_plus[fieldname] = jnp.asarray(vp)
        p_minus = dict(r.params)
        vm = vals.copy()
        vm[row] -= eps
        p_minus[fieldname] = jnp.asarray(vm)
        fd = (
            _loss(r, opt1, p_plus, target) - _loss(r, opt1, p_minus, target)
        ) / (2 * eps)
        assert abs(fd - ad) / (abs(fd) + 1e-8) < 0.08, (fieldname, fd, ad)


@pytest.fixture(scope="module")
def flat_scene(tmp_path_factory):
    """Uniform gray floor viewed dead-on from above + overhead area light:
    the configuration where the frozen-t camera derivative is EXACT for
    lateral eye moves (flat perpendicular plane: t is invariant under
    in-plane translation; uniform albedo: no image-content translation
    term, which autodiff drops because barycentric uvs are
    gradient-stopped). docs/parity.md #16 documents the omitted terms."""
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene

    d = tmp_path_factory.mktemp("flat")
    (d / "f.mtl").write_text(
        "newmtl gray\nmat_expr diffuse(reflectance: {0.6, 0.55, 0.5})\n\n"
        "newmtl lamp\nmat_expr emissive(radiance: {1, 1, 1}, scale: 14)\n\n"
    )
    (d / "f.obj").write_text(
        "mtllib f.mtl\n"
        "camera_fov 45\ncamera_eye 0.1 1.5 0.05\ncamera_look 0.1 0 0.05\n"
        "camera_up 0 0 -1\n"
        "v -3 0 -3\nv -3 0 3\nv 3 0 3\nv 3 0 -3\n"
        "usemtl gray\nf 1 2 3 4\n"
        # lamp above and behind the camera: lights the floor, out of frame
        "v -0.6 2.6 -0.6\nv 0.6 2.6 -0.6\nv 0.6 2.6 0.6\nv -0.6 2.6 0.6\n"
        "usemtl lamp\nf 5 6 7 8\n"
    )
    return compile_scene(read_scene(str(d / "f.obj")))


def test_camera_gradient_fd(flat_scene):
    """Camera-eye gradients FD-verified (round-4 VERDICT weak #6: 'finite
    and nonzero' is exactly the standard silhouette-bias can meet while
    being wrong). Lateral eye moves against a perpendicular flat plane are
    the regime where the frozen-t derivative is exact, so autodiff and the
    re-traced finite difference must agree at FD-test tolerance."""
    import dataclasses

    import jax.numpy as jnp

    from polaris_tpu.asset.camera import Camera
    from polaris_tpu.render.shade import tonemap_reinhard

    opt1 = RenderOptions(
        width=24, height=24, spp=2, num_bounces=1, min_bounces_for_rr=3
    )
    r = DifferentiableRenderer(flat_scene, mode="bvh")
    target = np.zeros((opt1.height, opt1.width, 3), np.float32)
    cam = Camera.from_scene(flat_scene, opt1.width, opt1.height)
    _, _, g_cam = r.loss_and_grad(opt1, target, camera=cam)
    g_eye = np.asarray(g_cam["eye"])
    assert np.isfinite(g_eye).all()

    def loss_with_eye(position):
        cam2 = dataclasses.replace(cam)
        cam2.position = np.asarray(position, np.float32)
        cam2.frustum = cam.frustum  # pure translation: corner rays fixed
        accum = np.asarray(r.render_accum(opt1, camera=cam2))
        img = tonemap_reinhard(np, accum + 1e-6, 1.0 / opt1.spp, opt1.exposure)
        return float(np.mean((img - target) ** 2))

    eps = 2e-3
    for axis in (0, 2):  # lateral axes (floor is y-up)
        p_plus = np.array(cam.position, np.float32)
        p_plus[axis] += eps
        p_minus = np.array(cam.position, np.float32)
        p_minus[axis] -= eps
        fd = (loss_with_eye(p_plus) - loss_with_eye(p_minus)) / (2 * eps)
        ad = float(g_eye[axis])
        assert fd != 0.0
        assert abs(fd - ad) / (abs(fd) + 1e-8) < 0.08, (axis, fd, ad)


def test_camera_frustum_gradient_fd(flat_scene):
    """One orientation parameter: a uniform x-shear of all four frustum
    corner rays (an image-space pan). Dead-on over a flat plane the
    frozen-t position error is second-order at the image center and the
    uniform albedo removes the content-translation term, so FD and AD
    agree at the same tolerance."""
    import jax.numpy as jnp

    from polaris_tpu.asset.camera import Camera
    from polaris_tpu.render.shade import tonemap_reinhard

    opt1 = RenderOptions(
        width=24, height=24, spp=2, num_bounces=1, min_bounces_for_rr=3
    )
    r = DifferentiableRenderer(flat_scene, mode="bvh")
    target = np.zeros((opt1.height, opt1.width, 3), np.float32)
    cam = Camera.from_scene(flat_scene, opt1.width, opt1.height)
    _, _, g_cam = r.loss_and_grad(opt1, target, camera=cam)
    g_fr = np.asarray(g_cam["frustum"])
    assert np.isfinite(g_fr).all() and np.abs(g_fr).max() > 0

    import dataclasses

    def loss_with_frustum(fr):
        cam2 = dataclasses.replace(cam)
        cam2.frustum = np.asarray(fr, np.float32)
        accum = np.asarray(r.render_accum(opt1, camera=cam2))
        img = tonemap_reinhard(np, accum + 1e-6, 1.0 / opt1.spp, opt1.exposure)
        return float(np.mean((img - target) ** 2))

    eps = 2e-3
    fr = np.array(cam.frustum, np.float32)
    fp = fr.copy()
    fp[:, 0] += eps
    fm = fr.copy()
    fm[:, 0] -= eps
    fd = (loss_with_frustum(fp) - loss_with_frustum(fm)) / (2 * eps)
    ad = float(g_fr[:, 0].sum())
    assert fd != 0.0
    assert abs(fd - ad) / (abs(fd) + 1e-8) < 0.08, (fd, ad)


def test_optimization_step_reduces_loss(cornell_scene, opt):
    """One SGD step on material colors must reduce an image-matching loss."""
    import jax

    r = DifferentiableRenderer(cornell_scene, mode="bvh")
    # target: render with darkened diffuse materials
    dark = dict(r.params)
    dark["mat_reflectance"] = r.params["mat_reflectance"] * 0.5
    from polaris_tpu.render.shade import tonemap_reinhard

    accum = np.asarray(r.render_from_params(opt, dark))
    target = tonemap_reinhard(np, accum + 1e-6, 1.0 / opt.spp, opt.exposure)

    loss0, g, _ = r.loss_and_grad(opt, target)
    lr = 0.25
    new_params = jax.tree.map(lambda p, gr: p - lr * gr, r.params, g)
    r_params_backup = r.params
    r.params = new_params
    loss1, _, _ = r.loss_and_grad(opt, target)
    r.params = r_params_backup
    assert loss1 < loss0, (loss0, loss1)
