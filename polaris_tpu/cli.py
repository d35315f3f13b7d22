"""polaris-tpu command line interface.

Counterpart of the reference's CLI (``main.go:41-179``; actions in
``cmd/render.go``, ``cmd/scene.go``, ``cmd/list_devices.go``):

  polaris-tpu render frame <scene>        single-frame render -> PNG
  polaris-tpu render progressive <scene>  progressive accumulation, writing
                                          snapshots (≙ interactive mode's
                                          +1-sample-per-frame loop without a
                                          GL window; see render/progressive)
  polaris-tpu scene compile <obj>         .obj -> compiled .zip artifact
  polaris-tpu scene info <scene>          size-breakdown table
  polaris-tpu devices                     list accelerator devices

Defaults mirror the reference (main.go:76-120): 1024x1024, 16 spp, 5
bounces, RR after 3, exposure 1.2.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .ops.intersect import MODES
from .utils.cache import enable_compile_cache
from .utils.log import get_logger, set_level

_log = get_logger("cli")


def _load_scene(path: str):
    from .asset.scene_data import SceneData

    if path.endswith(".zip"):
        return SceneData.load(path)
    from .asset.compiler.compiler import compile_scene
    from .asset.wavefront import read_scene

    return compile_scene(read_scene(path))


def _save_png(path: str, img01: np.ndarray) -> None:
    from .asset.png import save_image

    save_image(path, (np.clip(img01, 0, 1) * 255).astype(np.uint8))
    _log.info("wrote %s", path)


def _add_render_opts(p: argparse.ArgumentParser) -> None:
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--num-bounces", type=int, default=5)
    p.add_argument("--rr-bounces", type=int, default=3,
                   help="min bounces before Russian roulette")
    p.add_argument("--exposure", type=float, default=1.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", default="auto", choices=MODES,
                   help="traversal backend")
    p.add_argument("--tiles", type=int, default=0,
                   help="shard image rows over this many devices (0 = single)")
    p.add_argument("--sample-shards", type=int, default=1,
                   help="shard spp over this many devices (psum merge)")
    p.add_argument("--pool", type=int, default=0,
                   help="worker-pool mode: one feedback-scheduled worker "
                        "thread per device over this many devices "
                        "(heterogeneous backends; ≙ reference default "
                        "renderer + PerfectScheduler)")
    p.add_argument("--out", default="frame.png")
    p.add_argument("--debug", default=None,
                   help="render a debug channel: depth|normals|uv|hitmask|"
                        "instance|emissive_vis|throughput|accumulator")
    p.add_argument("--adaptive", type=float, default=0.0, metavar="TOL",
                   help="adaptive per-block sampling: --spp becomes the "
                        "budget cap; 32x32 blocks stop once the mean 95%% "
                        "CI of per-pixel luminance falls below TOL "
                        "(try 0.02; 0 = off)")
    p.add_argument("--denoise", type=int, default=0, metavar="ITERS",
                   help="edge-avoiding à-trous wavelet denoise of the HDR "
                        "frame before tonemapping, guided by a one-pass "
                        "normal+depth prepass (try 4; 0 = off; no reference "
                        "analogue — see docs/cli.md)")
    p.add_argument("--regen", action="store_true",
                   help="wavefront path regeneration: a dead lane restarts "
                        "at its own pixel with its next sample index inside "
                        "the render loop (estimator-exact; forward renders "
                        "only)")
    p.add_argument("--rr-tile-coherent", action="store_true",
                   help="draw the Russian-roulette uniform per 32x32 block "
                        "instead of per lane: unbiased, no measured variance "
                        "penalty, and blocks die atomically so late-bounce "
                        "traversal skips whole blocks of rays")
    p.add_argument("--blacklist", "-b", default=None,
                   help="skip devices whose names contain this value "
                        "(≙ reference --blacklist, default.go:243-252)")
    p.add_argument("--force-primary", default=None,
                   help="device-name substring to use as the primary "
                        "(first) device (≙ reference --force-primary, "
                        "default.go:255-266)")


def _select_devices(args):
    """Device selection with blacklist + primary election (the reference's
    initTracers policy, default.go:199-292). Returns an ordered list; the
    first entry is the primary."""
    import jax

    devices = list(jax.devices())
    bl = getattr(args, "blacklist", None)
    if bl:
        kept = [d for d in devices if bl.lower() not in str(d).lower()]
        for d in devices:
            if d not in kept:
                _log.warning("blacklisting device %s", d)
        devices = kept
    if not devices:
        # ≙ ErrNoTracers (renderer/errors.go:6-9)
        raise SystemExit("no usable devices after blacklist")
    fp = getattr(args, "force_primary", None)
    if fp:
        match = [d for d in devices if fp.lower() in str(d).lower()]
        if not match:
            raise SystemExit(f"no device matches --force-primary {fp!r}")
        devices = match[:1] + [d for d in devices if d is not match[0]]
        _log.info("primary device forced to %s", match[0])
    return devices


def cmd_render_frame(args) -> int:
    from .render.options import RenderOptions
    from .render.stats import FrameStats, WorkerFrameStats

    opt = RenderOptions(
        width=args.width, height=args.height, spp=args.spp,
        num_bounces=args.num_bounces, min_bounces_for_rr=args.rr_bounces,
        exposure=args.exposure, seed=args.seed,
        rr_tile_coherent=args.rr_tile_coherent,
    )
    if getattr(args, "regen", False) and (
        args.pool or args.tiles or args.sample_shards > 1
        or getattr(args, "adaptive", 0.0) > 0 or args.debug
    ):
        _log.error(
            "--regen applies to the plain single-device frame path; drop "
            "--pool/--tiles/--sample-shards/--adaptive/--debug"
        )
        return 2
    if getattr(args, "adaptive", 0.0) > 0 and (
        args.pool or args.tiles or args.sample_shards > 1
    ):
        _log.error(
            "--adaptive is single-device (per-block variance state lives "
            "with one renderer); drop --pool/--tiles/--sample-shards"
        )
        return 2
    if getattr(args, "denoise", 0) > 0 and (
        args.pool or args.tiles or args.sample_shards > 1
        or getattr(args, "adaptive", 0.0) > 0 or args.debug
    ):
        _log.error(
            "--denoise applies to the plain single-device frame path; drop "
            "--pool/--tiles/--sample-shards/--adaptive/--debug"
        )
        return 2
    scene = _load_scene(args.scene)

    import jax

    devices = _select_devices(args)
    pool = None
    mesh = None
    if args.debug:
        # debug channels are single-device diagnostics; render on the
        # elected primary regardless of pool/mesh flags
        from .render.debug import render_debug
        from .render.integrator import TpuRenderer

        with jax.default_device(devices[0]):
            img = render_debug(TpuRenderer(scene, mode=args.mode), opt, args.debug)
        _save_png(args.out, img)
        return 0
    if args.pool:
        from .parallel.workers import make_device_pool

        pool = make_device_pool(
            scene, mode=args.mode, devices=devices[: args.pool]
        )
        renderer = pool
        _log.info("worker pool over %d devices", args.pool)
    elif args.tiles or args.sample_shards > 1:
        from .parallel.mesh import DistributedRenderer, make_mesh

        tiles = args.tiles or 1
        mesh = make_mesh(tiles, args.sample_shards, devices=devices)
        renderer = DistributedRenderer(scene, mesh, mode=args.mode)
        _log.info("rendering on mesh %s", dict(mesh.shape))
    else:
        from .render.integrator import TpuRenderer

        renderer = TpuRenderer(
            scene, mode=args.mode, regen=getattr(args, "regen", False)
        )

    t0 = time.perf_counter()
    if pool is None and mesh is None:
        with jax.default_device(devices[0]):
            if getattr(args, "adaptive", 0.0) > 0:
                import numpy as _np

                img_u8, spp_map = renderer.render_adaptive_u8(
                    opt, tol=args.adaptive
                )
                img = img_u8.astype(_np.float32) / 255.0
                _log.info(
                    "adaptive: spp min/mean/max %d/%.1f/%d (budget %d)",
                    int(spp_map.min()), float(spp_map.mean()),
                    int(spp_map.max()), opt.spp,
                )
            elif getattr(args, "denoise", 0) > 0:
                from .render.denoise import denoise_accum
                from .render.shade import tonemap_reinhard

                accum = denoise_accum(
                    renderer, opt, np.asarray(renderer.render_accum(opt)),
                    opt.spp, iterations=args.denoise,
                )
                img = np.asarray(
                    tonemap_reinhard(np, accum, 1.0 / opt.spp, opt.exposure)
                )
            else:
                img = renderer.render(opt)
    else:
        img = renderer.render(opt)
    total_ms = (time.perf_counter() - t0) * 1e3
    _save_png(args.out, img)

    if pool is not None:
        # measured per-worker telemetry from the feedback scheduler path
        stats = pool.frame_stats
        stats.total_ms = total_ms
    else:
        stats = FrameStats(total_ms=total_ms)
        if mesh is not None:
            # one SPMD program spans all shards: report the real static
            # block assignment per tile shard, no fabricated per-device
            # times (cf. reference per-device table, cmd/render.go:82-101)
            n_tiles = mesh.shape["tile"]
            rows = args.height // n_tiles
            for ti in range(n_tiles):
                devs = ", ".join(str(d) for d in mesh.devices[ti])
                stats.workers.append(
                    WorkerFrameStats(
                        device_id=devs[:28],
                        block_w=args.width,
                        block_h=rows,
                    )
                )
            stats.finalize()
        else:
            stats.workers.append(
                WorkerFrameStats(
                    device_id=str(devices[0]),
                    block_w=args.width,
                    block_h=args.height,
                    render_time_ms=getattr(renderer, "last_render_ms", total_ms),
                )
            )
            stats.finalize()
    print(stats.table())
    return 0


def cmd_render_progressive(args) -> int:
    """Progressive accumulation: +spp samples per pass, periodic snapshots
    (≙ renderer/opengl.go:136-171 accumulation without the GL window)."""
    from .render.options import RenderOptions
    from .render.progressive import ProgressiveRenderer

    opt = RenderOptions(
        width=args.width, height=args.height, spp=max(1, args.spp),
        num_bounces=args.num_bounces, min_bounces_for_rr=args.rr_bounces,
        exposure=args.exposure, seed=args.seed,
        rr_tile_coherent=args.rr_tile_coherent,
    )
    if getattr(args, "adaptive", 0.0) > 0:
        # loud, like the --pool/--tiles rejection in cmd_render_frame: the
        # progressive loop has its own termination (ADVICE r4 #2)
        _log.error(
            "--adaptive applies to 'render frame' only; progressive passes "
            "accumulate until --target-spp"
        )
        return 2
    if getattr(args, "denoise", 0) > 0:
        _log.error(
            "--denoise applies to 'render frame' only; progressive "
            "snapshots stay unfiltered"
        )
        return 2
    if getattr(args, "regen", False) and getattr(args, "pool", 0):
        _log.error("--regen is single-renderer; drop --pool")
        return 2
    scene = _load_scene(args.scene)
    devices = _select_devices(args)
    pool = None
    if getattr(args, "pool", 0):
        from .parallel.workers import make_device_pool

        pool = make_device_pool(
            scene, mode=args.mode, devices=devices[: args.pool]
        )
    prog = ProgressiveRenderer(
        scene, opt, mode=args.mode, pool=pool,
        regen=getattr(args, "regen", False),
    )
    import contextlib

    import jax

    # single-renderer path runs pinned to the elected primary device
    ctx = (
        jax.default_device(devices[0]) if pool is None
        else contextlib.nullcontext()
    )
    with ctx:
        prog.run(
            target_samples=args.target_spp,
            snapshot_every=args.snapshot_every,
            out=args.out,
            serve_port=args.serve,
        )
    return 0


def cmd_scene_compile(args) -> int:
    from .asset.compiler.compiler import compile_scene
    from .asset.wavefront import read_scene

    t0 = time.perf_counter()
    scene = compile_scene(read_scene(args.scene))
    _log.info("compiled in %.0f ms", (time.perf_counter() - t0) * 1e3)
    out = args.out or os.path.splitext(args.scene)[0] + ".zip"
    t0 = time.perf_counter()
    scene.save(out)
    _log.info("serialized to %s in %.0f ms", out, (time.perf_counter() - t0) * 1e3)
    _print_scene_stats(scene)
    return 0


def _print_scene_stats(scene) -> None:
    print(f"{'Component':<24} {'Count':>10} {'Bytes':>12}")
    print("-" * 48)
    total = 0
    for name, (count, nbytes) in scene.stats().items():
        print(f"{name:<24} {count:>10} {nbytes:>12}")
        total += nbytes
    print("-" * 48)
    print(f"{'TOTAL':<24} {'':>10} {total:>12}")


def cmd_scene_info(args) -> int:
    scene = _load_scene(args.scene)
    _print_scene_stats(scene)
    print(
        f"\ncamera: fov={scene.camera_fov} eye={scene.camera_eye.tolist()} "
        f"look={scene.camera_look.tolist()}"
    )
    return 0


def cmd_devices(args) -> int:
    """List devices (≙ cmd/list_devices.go:13-38): platform, kind and
    device memory."""
    import jax

    print(f"{'Device':<28} {'Platform':>10} {'Kind':>24} {'Memory':>12}")
    print("-" * 78)
    for d in jax.devices():
        try:
            limit = (d.memory_stats() or {}).get("bytes_limit")
        except Exception:  # backends without memory stats
            limit = None
        mem = f"{limit / 2**30:.1f} GiB" if limit else "n/a"
        print(f"{str(d):<28} {d.platform:>10} {d.device_kind:>24} {mem:>12}")
    return 0


def main(argv=None) -> int:
    from . import __version__

    parser = argparse.ArgumentParser(prog="polaris-tpu")
    # -v / -vv verbosity levels (≙ main.go:33-38), --version (main.go:23-24)
    parser.add_argument("-v", action="count", default=0, dest="verbosity")
    parser.add_argument(
        "--version", action="version", version=f"polaris-tpu {__version__}"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_render = sub.add_parser("render", help="render commands")
    rsub = p_render.add_subparsers(dest="rcmd", required=True)

    pf = rsub.add_parser("frame", help="render a single frame")
    pf.add_argument("scene")
    _add_render_opts(pf)
    pf.set_defaults(fn=cmd_render_frame)

    pp = rsub.add_parser("progressive", help="progressive render")
    pp.add_argument("scene")
    _add_render_opts(pp)
    pp.add_argument("--target-spp", type=int, default=256)
    pp.add_argument("--snapshot-every", type=int, default=16)
    pp.add_argument("--serve", type=int, default=0,
                    help="serve live preview on this HTTP port")
    pp.set_defaults(fn=cmd_render_progressive)

    p_scene = sub.add_parser("scene", help="scene commands")
    ssub = p_scene.add_subparsers(dest="scmd", required=True)
    pc = ssub.add_parser("compile", help="compile .obj to a scene artifact")
    pc.add_argument("scene")
    pc.add_argument("--out", default=None)
    pc.set_defaults(fn=cmd_scene_compile)
    pi = ssub.add_parser("info", help="show compiled scene info")
    pi.add_argument("scene")
    pi.set_defaults(fn=cmd_scene_info)

    pd = sub.add_parser("devices", help="list devices")
    pd.set_defaults(fn=cmd_devices)

    args = parser.parse_args(argv)
    set_level(args.verbosity)
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
