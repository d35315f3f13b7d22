"""Multi-host (DCN) distribution.

The reference declared but never implemented a network backend
(`tracer.Remote` flag, tracer/tracer.go:52-58; README.md:26 "allows
implementation of a network backend to support multi-node multi-gpu
rendering"). Here it is realized by multi-process JAX: every host runs the
same SPMD program over the global mesh; NVLink carries the sample/grad psums
inside a host, the network carries cross-host collectives.

Because `DistributedRenderer` is written against a `jax.sharding.Mesh`, the
exact same rendering/training code runs unchanged on a multi-host mesh; this
module only adds process bootstrap + host-0 image assembly.

Testable without a cluster via `spawn_local_processes` (N CPU processes on
one machine — the multi-process analog of the virtual device mesh).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils.log import get_logger

_log = get_logger("multihost")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (env-driven on real TPU pods)."""
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)
    _log.info(
        "distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def make_global_mesh(tile: int, sample: int):
    """Mesh over the global device set, tile axis outermost so each host's
    local devices cover contiguous row bands (data stays host-local)."""
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices()).reshape(tile, sample)
    return Mesh(devs, ("tile", "sample"))


def render_multihost(scene, opt, tile: int, sample: int, mode: str = "auto"):
    """Render on the global mesh; every process returns the full image
    (host-local shards + allgather via jax array fetch)."""
    from .mesh import DistributedRenderer

    mesh = make_global_mesh(tile, sample)
    renderer = DistributedRenderer(scene, mesh, mode=mode)
    accum = renderer.render_accum(opt)
    # fetching a fully-addressable global array gathers over DCN
    import jax

    out = jax.experimental.multihost_utils.process_allgather(accum, tiled=True)
    return np.asarray(out)


# ----- single-machine multi-process test harness -----

_WORKER_SNIPPET = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address="127.0.0.1:{port}",
    num_processes={nproc},
    process_id={pid},
)
import numpy as np
from polaris_tpu.asset.scene_data import SceneData
from polaris_tpu.parallel.multihost import make_global_mesh
from polaris_tpu.parallel.mesh import DistributedRenderer
from polaris_tpu.render.options import RenderOptions

scene = SceneData.load({scene_path!r})
opt = RenderOptions(**{opt_kwargs!r})
mesh = make_global_mesh({tile}, {sample})
r = DistributedRenderer(scene, mesh, mode="pallas")
job = {job!r}
if job == "train":
    # one distributed optimization step: the parameter-gradient psum over
    # ('tile', 'sample') crosses PROCESS boundaries — i.e. rides DCN on a
    # real pod (mesh.py make_train_step)
    from jax.sharding import NamedSharding, PartitionSpec as P

    H, W = opt.height, opt.width
    target = np.zeros((H, W, 3), np.float32)
    tgt = jax.make_array_from_callback(
        (H, W, 3),
        NamedSharding(mesh, P("tile", None, None)),
        lambda idx: target[idx],
    )
    loss = r.train_step(opt, tgt, lr=0.1)
    if jax.process_index() == 0:
        np.savez(
            {out_path!r},
            loss=np.float32(loss),
            refl=np.asarray(r.params["mat_reflectance"]),
        )
else:
    accum = r.render_accum(opt)
    from jax.experimental import multihost_utils
    full = multihost_utils.process_allgather(accum, tiled=True)
    if jax.process_index() == 0:
        np.save({out_path!r}, np.asarray(full))
"""


def spawn_local_processes(
    scene_path: str,
    opt_kwargs: dict,
    num_processes: int,
    tile: int,
    sample: int,
    out_path: str,
    port: int = 12421,
    timeout: float = 600.0,
    job: str = "render",
) -> np.ndarray:
    """Run a real multi-process CPU job on this machine; ``job`` is
    'render' (returns the cross-process image) or 'train' (one distributed
    train_step; returns an npz with loss + updated reflectances) — the
    2-host scaling/training test stand-in."""
    import subprocess
    import sys

    procs = []
    for pid in range(num_processes):
        code = _WORKER_SNIPPET.format(
            port=port,
            nproc=num_processes,
            pid=pid,
            scene_path=scene_path,
            opt_kwargs=opt_kwargs,
            tile=tile,
            sample=sample,
            out_path=out_path,
            job=job,
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", code],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
        )
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        if p.returncode != 0:
            errs.append(err.decode()[-2000:])
    if errs:
        raise RuntimeError("worker failed:\n" + "\n---\n".join(errs))
    if job == "train" and not out_path.endswith(".npz"):
        out_path += ".npz"  # np.savez appends the suffix
    return np.load(out_path)
