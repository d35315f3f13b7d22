"""Procedurally generate the benchmark scene fixtures (.obj/.mtl/.hdr).

These correspond to the BASELINE.json configs:
  1. sphere.obj    — diffuse sphere + ground + area light (512^2 @ 16spp)
  2. cornell.obj   — Cornell box, area light, MIS, Russian roulette (64spp)
  3. mitsuba.obj   — roughConductor / roughDielectric + bilinear textures
  4. instanced.obj — two-level BVH with many transformed instances
  5. dispersive.obj— dispersive dielectric + HDR env map + Reinhard tonemap

All geometry is generated from scratch (icospheres, boxes, quads); nothing is
copied from the reference repository.
"""

from __future__ import annotations

import math
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def icosphere(subdiv: int = 2):
    """Unit icosphere: returns (verts[N,3], faces[M,3])."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [np.array(v, np.float64) / np.linalg.norm(v) for v in verts]

    cache = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key in cache:
            return cache[key]
        m = verts[a] + verts[b]
        m /= np.linalg.norm(m)
        verts.append(m)
        cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
    return np.stack(verts), np.array(faces, np.int64)


def _obj_mesh(f, name, verts, faces, material, v_base, scale=1.0, offset=(0, 0, 0),
              normals=None):
    f.write(f"o {name}\n")
    for v in verts:
        p = v * scale + np.asarray(offset, np.float64)
        f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
    if normals is not None:
        for n in normals:
            f.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
    f.write(f"usemtl {material}\n")
    for tri in faces:
        if normals is not None:
            idx = [f"{v_base + t + 1}//{v_base + t + 1}" for t in tri]
        else:
            idx = [str(v_base + t + 1) for t in tri]
        f.write("f " + " ".join(idx) + "\n")
    return v_base + len(verts)


def _quad(f, name, corners, material, v_base):
    """Quad from 4 corners (CCW)."""
    f.write(f"o {name}\n")
    for c in corners:
        f.write(f"v {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}\n")
    f.write(f"usemtl {material}\n")
    f.write("f " + " ".join(str(v_base + i) for i in [1, 2, 3, 4]) + "\n")
    return v_base + 4


def gen_sphere():
    """Config 1: diffuse sphere on a ground plane lit by an area light."""
    verts, faces = icosphere(3)
    with open(os.path.join(HERE, "sphere.mtl"), "w") as f:
        f.write("newmtl white\nmat_expr diffuse(reflectance: {0.75, 0.75, 0.75})\n\n")
        f.write("newmtl ball\nmat_expr diffuse(reflectance: {0.25, 0.35, 0.8})\n\n")
        f.write("newmtl lamp\nmat_expr emissive(radiance: {1, 1, 1}, scale: 18)\n\n")
    with open(os.path.join(HERE, "sphere.obj"), "w") as f:
        f.write("mtllib sphere.mtl\n")
        f.write("camera_fov 45\ncamera_eye 0 1.2 3.2\ncamera_look 0 0.7 0\ncamera_up 0 1 0\n")
        vb = 0
        vb = _obj_mesh(f, "ball", verts, faces, "ball", vb, scale=0.7,
                       offset=(0, 0.7, 0), normals=verts)
        vb = _quad(f, "floor", [(-4, 0, -4), (-4, 0, 4), (4, 0, 4), (4, 0, -4)],
                   "white", vb)
        vb = _quad(f, "lamp",
                   [(-0.8, 3.0, -0.8), (0.8, 3.0, -0.8), (0.8, 3.0, 0.8), (-0.8, 3.0, 0.8)],
                   "lamp", vb)


def gen_cornell():
    """Config 2: Cornell box with area light."""
    with open(os.path.join(HERE, "cornell.mtl"), "w") as f:
        f.write("newmtl white\nmat_expr diffuse(reflectance: {0.73, 0.73, 0.73})\n\n")
        f.write("newmtl red\nmat_expr diffuse(reflectance: {0.63, 0.065, 0.05})\n\n")
        f.write("newmtl green\nmat_expr diffuse(reflectance: {0.14, 0.45, 0.091})\n\n")
        f.write("newmtl light\nmat_expr emissive(radiance: {1, 0.85, 0.7}, scale: 17)\n\n")
        f.write("newmtl mirror\nmat_expr roughConductor(specularity: {0.9, 0.9, 0.92}, roughness: 0.2, intIOR: 0)\n\n")
    s = 1.0  # half box size
    with open(os.path.join(HERE, "cornell.obj"), "w") as f:
        f.write("mtllib cornell.mtl\n")
        f.write("camera_fov 40\ncamera_eye 0 1 3.8\ncamera_look 0 1 0\ncamera_up 0 1 0\n")
        vb = 0
        # floor (y=0), ceiling (y=2), back (z=-1), left red (x=-1), right green (x=1)
        vb = _quad(f, "floor", [(-s, 0, -s), (-s, 0, s), (s, 0, s), (s, 0, -s)], "white", vb)
        vb = _quad(f, "ceiling", [(-s, 2, -s), (s, 2, -s), (s, 2, s), (-s, 2, s)], "white", vb)
        vb = _quad(f, "back", [(-s, 0, -s), (s, 0, -s), (s, 2, -s), (-s, 2, -s)], "white", vb)
        vb = _quad(f, "left", [(-s, 0, -s), (-s, 2, -s), (-s, 2, s), (-s, 0, s)], "red", vb)
        vb = _quad(f, "right", [(s, 0, -s), (s, 0, s), (s, 2, s), (s, 2, -s)], "green", vb)
        vb = _quad(f, "light",
                   [(-0.25, 1.98, -0.25), (0.25, 1.98, -0.25), (0.25, 1.98, 0.25), (-0.25, 1.98, 0.25)],
                   "light", vb)
        # tall box (mirror) + short box (white)
        vb = _box(f, "tall", (-0.55, 0.0, -0.5), (-0.05, 1.2, -0.05), "mirror", vb)
        vb = _box(f, "short", (0.1, 0.0, 0.0), (0.65, 0.6, 0.55), "white", vb)


def _box(f, name, bmin, bmax, material, vb):
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    faces = [
        # -z, +z, -x, +x, -y, +y
        [(x0, y0, z0), (x0, y1, z0), (x1, y1, z0), (x1, y0, z0)],
        [(x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)],
        [(x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)],
        [(x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1)],
        [(x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)],
        [(x0, y1, z0), (x0, y1, z1), (x1, y1, z1), (x1, y1, z0)],
    ]
    for i, quad in enumerate(faces):
        vb = _quad(f, f"{name}_{i}", quad, material, vb)
    return vb


def _checker_png(path, n=8, size=64):
    import sys

    sys.path.insert(0, os.path.dirname(HERE))
    from polaris_tpu.asset.png import write_png

    tile = size // n
    img = np.zeros((size, size, 3), np.uint8)
    for y in range(size):
        for x in range(size):
            c = 230 if ((x // tile) + (y // tile)) % 2 == 0 else 40
            img[y, x] = (c, c, c)
    write_png(path, img)


def gen_mitsuba():
    """Config 3: microfacet materials + textured floor."""
    _checker_png(os.path.join(HERE, "checker.png"))
    verts, faces = icosphere(3)
    with open(os.path.join(HERE, "mitsuba.mtl"), "w") as f:
        f.write('newmtl floor\nmat_expr diffuse(reflectance: "checker.png")\n\n')
        f.write("newmtl rough_gold\nmat_expr roughConductor(specularity: {0.9, 0.7, 0.3}, roughness: 0.25)\n\n")
        f.write('newmtl rough_glass\nmat_expr roughDielectric(transmittance: {0.95, 0.95, 0.95}, intIOR: "Glass", roughness: 0.15)\n\n')
        f.write("newmtl lamp\nmat_expr emissive(radiance: {1, 1, 1}, scale: 14)\n\n")
    with open(os.path.join(HERE, "mitsuba.obj"), "w") as f:
        f.write("mtllib mitsuba.mtl\n")
        f.write("camera_fov 45\ncamera_eye 0 1.4 3.4\ncamera_look 0 0.6 0\ncamera_up 0 1 0\n")
        vb = 0
        vb = _obj_mesh(f, "gold", verts, faces, "rough_gold", vb, scale=0.6,
                       offset=(-0.8, 0.6, 0), normals=verts)
        vb = _obj_mesh(f, "glass", verts, faces, "rough_glass", vb, scale=0.6,
                       offset=(0.8, 0.6, 0), normals=verts)
        # textured floor with uvs
        f.write("o floor\n")
        for c in [(-4, 0, -4), (-4, 0, 4), (4, 0, 4), (4, 0, -4)]:
            f.write(f"v {c[0]} {c[1]} {c[2]}\n")
        for u, v in [(0, 0), (0, 4), (4, 4), (4, 0)]:
            f.write(f"vt {u} {v}\n")
        f.write("usemtl floor\n")
        f.write(f"f {vb+1}/1 {vb+2}/2 {vb+3}/3 {vb+4}/4\n")
        vb += 4
        vb = _quad(f, "lamp",
                   [(-1, 3.2, -1), (1, 3.2, -1), (1, 3.2, 1), (-1, 3.2, 1)],
                   "lamp", vb)


def gen_instanced():
    """Config 4: grid of transformed instances of one mesh."""
    verts, faces = icosphere(2)
    with open(os.path.join(HERE, "instanced.mtl"), "w") as f:
        f.write("newmtl ball\nmat_expr diffuse(reflectance: {0.6, 0.3, 0.2})\n\n")
        f.write("newmtl white\nmat_expr diffuse(reflectance: {0.75, 0.75, 0.75})\n\n")
        f.write("newmtl lamp\nmat_expr emissive(radiance: {1, 1, 1}, scale: 20)\n\n")
    with open(os.path.join(HERE, "instanced.obj"), "w") as f:
        f.write("mtllib instanced.mtl\n")
        f.write("camera_fov 50\ncamera_eye 0 2.5 6\ncamera_look 0 0.5 0\ncamera_up 0 1 0\n")
        vb = 0
        vb = _obj_mesh(f, "ball", verts, faces, "ball", vb, scale=1.0,
                       offset=(0, 0, 0), normals=verts)
        vb = _quad(f, "floor", [(-8, 0, -8), (-8, 0, 8), (8, 0, 8), (8, 0, -8)],
                   "white", vb)
        vb = _quad(f, "lamp",
                   [(-1.5, 5, -1.5), (1.5, 5, -1.5), (1.5, 5, 1.5), (-1.5, 5, 1.5)],
                   "lamp", vb)
        # 4x4 grid of shrunken rotated spheres + floor/lamp instances
        f.write("instance floor 0 0 0 0 0 0 1 1 1\n")
        f.write("instance lamp 0 0 0 0 0 0 1 1 1\n")
        for i in range(4):
            for j in range(4):
                x = (i - 1.5) * 1.4
                z = (j - 1.5) * 1.4
                s = 0.25 + 0.05 * ((i + j) % 3)
                rot = 20.0 * (i * 4 + j)
                f.write(
                    f"instance ball {x:.3f} {s:.3f} {z:.3f} 0 {rot:.1f} 0 {s:.3f} {s:.3f} {s:.3f}\n"
                )


def _env_hdr(path, w=128, h=64):
    """Small synthetic HDR gradient env map with a bright 'sun' disc."""
    from polaris_tpu.asset.texture import write_hdr

    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    v = ys / (h - 1.0)
    sky = np.stack(
        [0.35 + 0.2 * (1 - v), 0.5 + 0.3 * (1 - v), 0.9 - 0.2 * v], axis=-1
    ).astype(np.float32)
    # sun at u=0.25, v=0.3
    du = xs / (w - 1.0) - 0.25
    dv = v - 0.3
    sun = np.exp(-(du * du + dv * dv) / 0.002).astype(np.float32)
    rgb = sky + sun[..., None] * np.array([40.0, 36.0, 30.0], np.float32)
    write_hdr(path, rgb.astype(np.float32))


def gen_dispersive():
    """Config 5: dispersive dielectric sphere under an HDR env light."""
    _env_hdr(os.path.join(HERE, "env.hdr"))
    verts, faces = icosphere(3)
    with open(os.path.join(HERE, "dispersive.mtl"), "w") as f:
        f.write(
            "newmtl prism\nmat_expr disperse(dielectric(transmittance: {0.97, 0.97, 0.97}), "
            "intIOR: {1.513, 1.519, 1.528}, extIOR: {0, 0, 0})\n\n"
        )
        f.write("newmtl white\nmat_expr diffuse(reflectance: {0.7, 0.7, 0.7})\n\n")
        f.write('newmtl scene_diffuse_material\nmat_expr diffuse(reflectance: "env.hdr")\n\n')
        f.write('newmtl scene_emissive_material\nmat_expr emissive(radiance: "env.hdr", scale: 1)\n\n')
    with open(os.path.join(HERE, "dispersive.obj"), "w") as f:
        f.write("mtllib dispersive.mtl\n")
        f.write("camera_fov 45\ncamera_eye 0 1.0 3.0\ncamera_look 0 0.7 0\ncamera_up 0 1 0\n")
        vb = 0
        vb = _obj_mesh(f, "prism", verts, faces, "prism", vb, scale=0.7,
                       offset=(0, 0.7, 0), normals=verts)
        vb = _quad(f, "floor", [(-4, 0, -4), (-4, 0, 4), (4, 0, 4), (4, 0, -4)],
                   "white", vb)


def main():
    gen_sphere()
    gen_cornell()
    gen_mitsuba()
    gen_instanced()
    gen_dispersive()
    print("wrote scene fixtures to", HERE)


if __name__ == "__main__":
    main()
