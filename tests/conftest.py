"""Test harness: force JAX onto a virtual 8-device CPU mesh.

The tests run on the CPU, also on a machine with a GPU: they must be
hermetic and exercise multi-device sharding without hardware, per the
reference's mock-tracer testing strategy (SURVEY.md §4). Pallas kernels run
in interpret mode here; chip_smoke.py runs them compiled on the GPU.
"""

import os

# Must be set before jax imports anywhere.
os.environ["JAX_PLATFORM_NAME"] = "cpu"
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# keep every backend but the CPU uninitialized, even where a GPU is present
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def run_cli():
    """Run the CLI in a hermetic forced-CPU subprocess. The ONE place that
    knows the environment quirks (platform override, device count,
    in-tree import path) — CLI smoke tests across files share it."""
    import subprocess
    import sys

    def _run(args, cwd, n_devices=1):
        env = dict(os.environ)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env.update(
            JAX_PLATFORMS="cpu",
            JAX_PLATFORM_NAME="cpu",
            XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
            # the subprocess runs from a tmp cwd; make the in-tree package
            # importable without requiring an installed wheel
            PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""),
        )
        return subprocess.run(
            [sys.executable, "-m", "polaris_tpu.cli", *args],
            capture_output=True, text=True, cwd=cwd, env=env, timeout=300,
        )

    return _run


@pytest.fixture(scope="session")
def scenes_dir():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = os.path.join(here, "scenes")
    if not os.path.exists(os.path.join(d, "cornell.obj")):
        import subprocess, sys

        subprocess.run([sys.executable, os.path.join(d, "generate.py")], check=True)
    return d


@pytest.fixture(scope="session")
def cornell_scene(scenes_dir):
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene

    return compile_scene(read_scene(os.path.join(scenes_dir, "cornell.obj")))


@pytest.fixture(scope="session")
def sphere_scene(scenes_dir):
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene

    return compile_scene(read_scene(os.path.join(scenes_dir, "sphere.obj")))


@pytest.fixture(scope="session")
def textured_scene(scenes_dir, tmp_path_factory):
    """Tiny scene for texture/rough-leaf gradient tests: a checker-textured
    floor, a vertical rough-conductor panel (roughness + IOR leaves in play),
    and an area light — 6 triangles, fast in bvh mode on CPU."""
    import shutil

    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.wavefront import read_scene

    d = tmp_path_factory.mktemp("textured")
    shutil.copy(os.path.join(scenes_dir, "checker.png"), d / "checker.png")
    (d / "t.mtl").write_text(
        'newmtl tfloor\nmat_expr diffuse(reflectance: "checker.png")\n\n'
        "newmtl rough\nmat_expr roughConductor(specularity: {0.9, 0.8, 0.6},"
        " roughness: 0.3, intIOR: 1.8)\n\n"
        "newmtl lamp\nmat_expr emissive(radiance: {1, 1, 1}, scale: 16)\n\n"
    )
    (d / "t.obj").write_text(
        "mtllib t.mtl\n"
        "camera_fov 45\ncamera_eye 0 1.0 2.5\ncamera_look 0 0.5 0\n"
        "camera_up 0 1 0\n"
        # textured floor (uvs span 2 checker periods)
        "v -2 0 -2\nv -2 0 2\nv 2 0 2\nv 2 0 -2\n"
        "vt 0 0\nvt 0 2\nvt 2 2\nvt 2 0\n"
        "usemtl tfloor\nf 1/1 2/2 3/3 4/4\n"
        # vertical rough panel facing the camera
        "v -1.5 0 -1.8\nv 1.5 0 -1.8\nv 1.5 2 -1.8\nv -1.5 2 -1.8\n"
        "usemtl rough\nf 5 6 7 8\n"
        # lamp overhead
        "v -0.7 2.8 -0.7\nv 0.7 2.8 -0.7\nv 0.7 2.8 0.7\nv -0.7 2.8 0.7\n"
        "usemtl lamp\nf 9 10 11 12\n"
    )
    # float_textures: the gradient/trainer tests differentiate tex_data,
    # which requires the f32 atlas (byte storage is the u8 default —
    # tests/test_compiler.py::test_byte_texture_storage covers that path)
    return compile_scene(read_scene(str(d / "t.obj")), float_textures=True)
