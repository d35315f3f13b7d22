"""Scene compiler tests (ref test model: compiler_test.go — texture baking
offsets, BVH/TLAS layout, material tree compilation)."""

import os
import numpy as np
import pytest

from polaris_tpu.asset import material as M
from polaris_tpu.asset.scene_data import AREA_LIGHT, ENVIRONMENT_LIGHT, SceneData


def test_cornell_structure(cornell_scene):
    sc = cornell_scene
    assert sc.num_triangles == 36  # 5 walls + light + 2 boxes(6 quads each)
    # TLAS leaf per instance with ldata = -instance
    tlas_leaves = np.nonzero((sc.bvh_ldata <= 0) & (sc.bvh_rdata == 0))[0]
    insts = sorted(-sc.bvh_ldata[tlas_leaves])
    assert insts == list(range(sc.inst_bvh_root.shape[0]))
    # area light cloned once (1 instance) + no env light
    assert np.all(sc.emis_type == AREA_LIGHT)
    assert sc.emis_area.shape[0] == 2  # light quad = 2 triangles
    # light triangle areas: 0.5 * 0.5 quad split in two
    np.testing.assert_allclose(sc.emis_area, [0.125, 0.125], rtol=1e-5)
    assert sc.scene_diffuse_mat == -1


def test_material_nodes(cornell_scene):
    sc = cornell_scene
    # 5 materials, all leaves
    assert np.all(sc.mat_type[: sc.mat_type.shape[0]] < 10000)
    types = set(int(t) for t in sc.mat_type)
    assert M.BXDF_DIFFUSE in types
    assert M.BXDF_EMISSIVE in types
    assert M.BXDF_ROUGH_CONDUCTOR in types
    # roughConductor with intIOR: 0 override (F = 1)
    cond = np.nonzero(sc.mat_type == M.BXDF_ROUGH_CONDUCTOR)[0][0]
    assert sc.mat_int_ior[cond] == 0.0
    assert sc.mat_roughness[cond] == np.float32(0.2)


def test_blas_ranges_contiguous(cornell_scene):
    from polaris_tpu.cpu_ref.renderer import _collect_blas_triangles

    sc = cornell_scene
    seen = []
    for root in set(int(r) for r in sc.inst_bvh_root):
        tris = _collect_blas_triangles(sc, root)
        assert tris.max() - tris.min() + 1 == tris.size
        seen.extend(tris.tolist())
    assert sorted(seen) == list(range(sc.num_triangles))


def test_dispersive_env_scene(scenes_dir):
    import os

    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene

    sc = compile_scene(read_scene(os.path.join(scenes_dir, "dispersive.obj")))
    assert sc.scene_diffuse_mat >= 0
    assert sc.scene_emissive_mat >= 0
    assert ENVIRONMENT_LIGHT in set(int(t) for t in sc.emis_type)
    # disperse op node present with per-channel IORs
    disp = np.nonzero(sc.mat_type == M.OP_DISPERSE)[0]
    assert disp.size == 1
    assert sc.mat_int_disp_ior[disp[0], 0] > 1.5
    # env map baked into atlas
    assert sc.tex_offset.shape[0] >= 2  # env.hdr + dummy


def test_scene_io_roundtrip(tmp_path, cornell_scene):
    import dataclasses

    p = str(tmp_path / "scene.zip")
    cornell_scene.save(p)
    loaded = SceneData.load(p)
    for f in dataclasses.fields(SceneData):
        a = getattr(cornell_scene, f.name)
        b = getattr(loaded, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b or np.allclose(a, b), f.name


def test_circular_material_reference(tmp_path):
    from polaris_tpu.asset.compiler.compiler import CompileError, compile_scene
    from polaris_tpu.asset.wavefront import read_scene

    (tmp_path / "lib.mtl").write_text(
        'newmtl a\nmat_expr mix("b", diffuse(), 0.5)\n'
        'newmtl b\nmat_expr mix("a", diffuse(), 0.5)\n'
    )
    (tmp_path / "s.obj").write_text(
        "mtllib lib.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl a\nf 1 2 3\n"
    )
    with pytest.raises(CompileError):
        compile_scene(read_scene(str(tmp_path / "s.obj")))


def test_instanced_scene(scenes_dir):
    import os

    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene

    sc = compile_scene(read_scene(os.path.join(scenes_dir, "instanced.obj")))
    n_inst = sc.inst_bvh_root.shape[0]
    assert n_inst == 18  # 16 balls + floor + lamp
    # instances share BLAS roots
    assert len(set(int(r) for r in sc.inst_bvh_root)) == 3
    # emissive clones: lamp instanced once -> 2 triangles
    assert sc.emis_area.shape[0] == 2
    # w2o really is the inverse of o2w
    for i in range(n_inst):
        np.testing.assert_allclose(
            sc.inst_w2o[i] @ sc.inst_o2w[i], np.eye(4), atol=1e-4
        )


def test_byte_texture_storage(scenes_dir, tmp_path):
    """LDR textures keep byte storage (texture_fmt.go:5-10 Luminance8 /
    Rgba8), dequantized on sample: 4x less atlas HBM, bit-identical
    renders vs float_textures=True (the training storage)."""
    import shutil

    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene
    from polaris_tpu.render.integrator import TpuRenderer
    from polaris_tpu.render.options import RenderOptions

    shutil.copy(os.path.join(scenes_dir, "checker.png"), tmp_path / "checker.png")
    (tmp_path / "b.mtl").write_text(
        'newmtl floor\nmat_expr diffuse(reflectance: "checker.png")\n\n'
        "newmtl lamp\nmat_expr emissive(radiance: {1, 1, 1}, scale: 10)\n\n"
    )
    (tmp_path / "b.obj").write_text(
        "mtllib b.mtl\n"
        "camera_fov 45\ncamera_eye 0 1.0 2.5\ncamera_look 0 0 0\n"
        "v -2 0 -2\nv -2 0 2\nv 2 0 2\nv 2 0 -2\n"
        "vt 0 0\nvt 0 2\nvt 2 2\nvt 2 0\n"
        "usemtl floor\nf 1/1 2/2 3/3 4/4\n"
        "v -0.7 2.8 -0.7\nv 0.7 2.8 -0.7\nv 0.7 2.8 0.7\nv -0.7 2.8 0.7\n"
        "usemtl lamp\nf 5 6 7 8\n"
    )
    raw = read_scene(str(tmp_path / "b.obj"))
    sc_u8 = compile_scene(raw)
    sc_f32 = compile_scene(raw, float_textures=True)
    # byte storage actually engaged, and it is 4x smaller
    assert (sc_u8.tex_store[:-1] == 1).any()
    assert sc_u8.tex_data_u8.size > 0
    assert sc_u8.tex_data_u8.nbytes * 4 <= sc_f32.tex_data.nbytes
    # byte atlas lives in geom (not a differentiable leaf)
    geom, params = sc_u8.split_params()
    assert "tex_data_u8" in geom and "tex_data" in params
    # renders are bit-identical (u8 sources round-trip exactly)
    opt = RenderOptions(width=32, height=32, spp=1, num_bounces=2,
                        min_bounces_for_rr=3)
    a = np.asarray(TpuRenderer(sc_u8, mode="bvh").render_accum(opt))
    b = np.asarray(TpuRenderer(sc_f32, mode="bvh").render_accum(opt))
    np.testing.assert_array_equal(a, b)
    # artifact round-trip keeps byte storage
    sc_u8.save(str(tmp_path / "c.zip"))
    from polaris_tpu.asset.scene_data import SceneData

    sc2 = SceneData.load(str(tmp_path / "c.zip"))
    np.testing.assert_array_equal(sc2.tex_data_u8, sc_u8.tex_data_u8)
    np.testing.assert_array_equal(sc2.tex_store, sc_u8.tex_store)


def test_byte_textures_slow_path_guarded(scenes_dir, tmp_path):
    """The legacy flat-f32 texture fallback refuses byte-stored scenes
    loudly instead of fetching garbage (review finding)."""
    import shutil

    import pytest as _pytest

    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene
    from polaris_tpu.ops.texture import tex_sample_rgba

    shutil.copy(os.path.join(scenes_dir, "checker.png"), tmp_path / "checker.png")
    (tmp_path / "g.mtl").write_text(
        'newmtl floor\nmat_expr diffuse(reflectance: "checker.png")\n\n'
    )
    (tmp_path / "g.obj").write_text(
        "mtllib g.mtl\nv -1 0 -1\nv -1 0 1\nv 1 0 1\n"
        "vt 0 0\nvt 0 1\nvt 1 1\nusemtl floor\nf 1/1 2/2 3/3\n"
    )
    sc = compile_scene(read_scene(str(tmp_path / "g.obj")))
    geom, params = sc.split_params()
    S = {**geom, **params}
    uv = np.array([[0.5, 0.5]], np.float32)
    with _pytest.raises(ValueError, match="byte-stored"):
        tex_sample_rgba(np, S, uv, np.array([0], np.int32))
