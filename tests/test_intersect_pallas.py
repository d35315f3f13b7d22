"""The Pallas traversal kernel (ops/intersect_pallas.py) in interpret mode
against the XLA per-lane reference (``intersect_bvh``), plus the pieces
around it that choose and build it: the route, interpret mode, ``auto``,
the compile cache, the stdlib PNG path and chip_smoke.py's refusal to run
without a GPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from polaris_tpu.ops import intersect_pallas as K
from polaris_tpu.ops.intersect import (
    GPU_AUTO_MODE,
    auto_mode,
    intersect_bvh,
    make_intersectors,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scenes(scenes_dir):
    from polaris_tpu.asset.compiler.compiler import compile_scene
    from polaris_tpu.asset.procedural import make_terrain_scene
    from polaris_tpu.asset.wavefront import read_scene

    cache = {}

    def get(name):
        if name not in cache:
            if name == "terrain":
                raw = make_terrain_scene(grid=24)
            else:
                raw = read_scene(os.path.join(scenes_dir, f"{name}.obj"))
            cache[name] = compile_scene(raw)
        return cache[name]

    return get


def _rays(scene, n, seed=0, active_frac=0.9):
    """Half camera rays, half random rays from inside the scene bounds."""
    rng = np.random.default_rng(seed)
    eye = np.asarray(scene.camera_eye, np.float64)
    fwd = np.asarray(scene.camera_look, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    h = n // 2
    d1 = fwd + 0.4 * rng.normal(size=(h, 3))
    lo, hi = scene.bvh_min.min(0), scene.bvh_max.max(0)
    o = np.concatenate([np.repeat(eye[None], h, 0), rng.uniform(lo, hi, (n - h, 3))])
    d = np.concatenate([d1, rng.normal(size=(n - h, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.where(rng.uniform(size=n) < 0.5, 3.0e38, rng.uniform(0.1, 5.0, n))
    act = rng.uniform(size=n) < active_frac
    return (
        jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
        jnp.asarray(maxt, jnp.float32), jnp.asarray(act),
    )


def _both(scene, rays, any_hit):
    geom, _ = scene.split_params()
    S = {k: jnp.asarray(v) for k, v in geom.items() if not k.startswith("_")}
    P = {k: jnp.asarray(v) for k, v in K.pack_scene(scene).items()}
    ref = intersect_bvh(S, *rays, any_hit=any_hit)
    got = K.intersect_pallas(P, *rays, any_hit=any_hit)
    return ref, got


@pytest.mark.parametrize("name", ["cornell", "sphere", "instanced", "terrain"])
def test_closest_hit_matches_bvh(scenes, name):
    rays = _rays(scenes(name), 2048)
    ref, got = _both(scenes(name), rays, any_hit=False)
    mask = np.asarray(ref.mask)
    assert mask.sum() > 100  # the rays really hit something
    np.testing.assert_array_equal(np.asarray(got.mask), mask)
    np.testing.assert_array_equal(np.asarray(got.inst)[mask], np.asarray(ref.inst)[mask])
    np.testing.assert_array_equal(np.asarray(got.tri)[mask], np.asarray(ref.tri)[mask])
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t), rtol=1e-5)
    # interpret mode runs the kernel's dot products as explicit adds while
    # XLA:CPU reduces the reference's (a different rounding): on grazing
    # hits u/v then move by a few 1e-5. chip_smoke.py holds the compiled
    # kernel to 1e-5 on the GPU.
    for f in ("u", "v"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, f))[mask], np.asarray(getattr(ref, f))[mask],
            atol=1e-4,
        )
    assert (np.asarray(got.t)[~mask] == 0).all()


@pytest.mark.parametrize("name", ["cornell", "instanced"])
def test_any_hit_matches_bvh(scenes, name):
    rays = _rays(scenes(name), 2048, seed=1)
    ref, got = _both(scenes(name), rays, any_hit=True)
    assert np.asarray(ref.mask).sum() > 100
    np.testing.assert_array_equal(np.asarray(got.mask), np.asarray(ref.mask))


def test_ragged_ray_count(scenes):
    """A ray count that does not fill the last block: the tail lanes are
    masked, the outputs keep the caller's length."""
    n = 3 * K.BLOCK + 5
    rays = _rays(scenes("cornell"), n, seed=2)
    ref, got = _both(scenes("cornell"), rays, any_hit=False)
    assert got.t.shape == (n,) and got.mask.shape == (n,)
    np.testing.assert_array_equal(np.asarray(got.tri), np.asarray(ref.tri))
    np.testing.assert_array_equal(np.asarray(got.mask), np.asarray(ref.mask))


def test_all_inactive_rays(scenes):
    o, d, maxt, _ = _rays(scenes("cornell"), 200, seed=3)
    act = jnp.zeros(200, bool)
    P = {k: jnp.asarray(v) for k, v in K.pack_scene(scenes("cornell")).items()}
    for any_hit in (False, True):
        hit = K.intersect_pallas(P, o, d, maxt, act, any_hit=any_hit)
        assert not np.asarray(hit.mask).any()
        assert (np.asarray(hit.t) == 0).all()


def _pallas_eqn(n, any_hit, interpret):
    call = K._build_call(n, any_hit, interpret)
    args = (
        jnp.zeros(4, jnp.int32), jnp.zeros(24, jnp.float32),
        jnp.zeros(9, jnp.float32), jnp.zeros(12, jnp.float32),
        jnp.zeros(1, jnp.int32), jnp.zeros(3 * n, jnp.float32),
        jnp.zeros(3 * n, jnp.float32), jnp.zeros(n, jnp.float32),
        jnp.zeros(n, jnp.int32),
    )
    jaxpr = jax.make_jaxpr(call)(*args)
    (eqn,) = [e for e in jaxpr.eqns if e.primitive.name == "pallas_call"]
    return eqn, call, args


def test_call_names_triton_route():
    eqn, _, _ = _pallas_eqn(100, False, False)
    assert eqn.params["backend"] == "triton"
    assert "triton" in eqn.params["compiler_params"]
    assert not eqn.params["interpret"]


@pytest.mark.parametrize(
    "platform,expect", [("cpu", True), ("gpu", False), ("tpu", None)]
)
def test_interpret_only_on_cpu(platform, expect):
    if expect is None:
        with pytest.raises(RuntimeError):
            K.interpret_on(platform)
    else:
        assert K.interpret_on(platform) is expect


def test_kernel_lowers_to_triton_for_cuda():
    """Lower the compiled (non-interpret) call for CUDA without a GPU: the
    whole kernel body must translate to Triton IR."""
    _, call, args = _pallas_eqn(130, True, False)
    text = jax.jit(call).trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text


@pytest.mark.parametrize(
    "platform,expect", [("cpu", "packet"), ("gpu", GPU_AUTO_MODE), ("tpu", None)]
)
def test_auto_mode_by_platform(platform, expect):
    if expect is None:
        with pytest.raises(RuntimeError):
            auto_mode(platform)
    else:
        assert auto_mode(platform) == expect


def test_unknown_mode_refused(scenes):
    with pytest.raises(ValueError):
        make_intersectors(None, scenes("cornell"), "pallas8")


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    from polaris_tpu.utils import cache

    seen = {}
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: seen.__setitem__(k, v)
    )
    if env_set:
        monkeypatch.setenv(cache.ENV, str(tmp_path))
        assert cache.enable_compile_cache() == str(tmp_path)
        assert seen == {}  # JAX reads the variable itself
    else:
        monkeypatch.delenv(cache.ENV, raising=False)
        path = cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert seen == {"jax_compilation_cache_dir": path}


def test_png_round_trip(tmp_path):
    from polaris_tpu.asset.png import read_png, save_image

    rng = np.random.default_rng(0)
    for shape in ((7, 5), (9, 4, 3), (3, 8, 4)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        p = str(tmp_path / "x.png")
        save_image(p, img)
        back = read_png(p)
        np.testing.assert_array_equal(back.reshape(img.shape), img)


def test_checker_png_decodes_like_pillow(scenes_dir):
    Image = pytest.importorskip("PIL.Image")
    from polaris_tpu.asset.png import read_png

    path = os.path.join(scenes_dir, "checker.png")
    np.testing.assert_array_equal(read_png(path), np.asarray(Image.open(path)))


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=240,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
