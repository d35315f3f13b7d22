"""Host-static scene specialization for the shading path.

XLA computes BOTH sides of every ``where``, so a texture-free scene still
paid for 4 bilinear atlas gathers per material field per lane (~0.3 ms per
gathered column at 512^2) and every scene paid for all five BxDF branches.
This module captures, once per scene on the host, which features can occur
at all — texture-backed material fields, BxDF types, material-tree
operators, light kinds — and threads the result through the scene dict as a
jit-static sidecar so the shading code can drop dead branches at trace time.

Numerics-preserving by construction: a skipped branch could only ever feed a
``where`` whose predicate is False on every lane (the predicate is a
per-lane comparison against data that the host just proved absent), so the
specialized program is bit-identical to the full one. The CPU oracle
(cpu_ref) shares the same scene dict and therefore the same specialization.

The sidecar rides in the scene dict under the ``"_stx"`` key as an aux-only
pytree node: it flattens to zero leaves, so jit treats it as static and
retraces when it changes; ``jax.tree`` maps skip it.
"""

from __future__ import annotations

import jax
import numpy as np

# material fields that can be texture-backed (matches MATERIAL_FIELDS pairs)
TEXTURE_FIELDS = (
    "reflectance",
    "specularity",
    "transmittance",
    "radiance",
    "roughness",
)


@jax.tree_util.register_pytree_node_class
class Static:
    """An immutable, hashable value that is jit-STATIC inside a pytree."""

    def __init__(self, **kw):
        object.__setattr__(self, "_d", dict(kw))

    def __getattr__(self, name):
        try:
            return object.__getattribute__(self, "_d")[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        raise AttributeError("Static is immutable")

    def _key(self):
        return tuple(sorted(self._d.items()))

    def tree_flatten(self):
        return (), self._key()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(**dict(aux))

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, Static) and self._key() == other._key()

    def __repr__(self):
        return f"Static({self._d})"


def scene_statics(scene) -> Static:
    """Derive the specialization sidecar from a compiled SceneData."""
    from .bxdf import (
        BXDF_CONDUCTOR,
        BXDF_DIELECTRIC,
        BXDF_DIFFUSE,
        BXDF_EMISSIVE,
        BXDF_ROUGH_CONDUCTOR,
        BXDF_ROUGH_DIELECTRIC,
    )
    from .material import (
        OP_BUMP_MAP,
        OP_DISPERSE,
        OP_MIX,
        OP_MIX_MAP,
        OP_NORMAL_MAP,
    )

    mt = np.asarray(scene.mat_type)
    tex_fields = frozenset(
        f
        for f in TEXTURE_FIELDS
        if bool((np.asarray(getattr(scene, f"mat_{f}_tex")) >= 0).any())
    )
    ops = frozenset(
        name
        for name, op in (
            ("mix", OP_MIX),
            ("mixmap", OP_MIX_MAP),
            ("bump", OP_BUMP_MAP),
            ("normal", OP_NORMAL_MAP),
            ("disperse", OP_DISPERSE),
        )
        if bool((mt == op).any())
    )
    bxdf_types = frozenset(
        int(b)
        for b in (
            BXDF_EMISSIVE,
            BXDF_DIFFUSE,
            BXDF_CONDUCTOR,
            BXDF_ROUGH_CONDUCTOR,
            BXDF_DIELECTRIC,
            BXDF_ROUGH_DIELECTRIC,
        )
        if bool((mt == b).any())
    )
    et = np.asarray(scene.emis_type)
    lights = frozenset(
        name for name, v in (("area", 0), ("env", 1)) if bool((et == v).any())
    )
    bg = int(scene.scene_diffuse_mat)
    bg_tex = bool(
        bg >= 0 and int(np.asarray(scene.mat_reflectance_tex)[bg]) >= 0
    )
    tex_fields, ops, bxdf_types, lights, bg_tex = _apply_force(
        tex_fields, ops, bxdf_types, lights, bg_tex
    )
    return Static(
        tex_fields=tex_fields,
        ops=ops,
        bxdf_types=bxdf_types,
        lights=lights,
        bg_tex=bg_tex,
    )


def _apply_force(tex_fields, ops, bxdf_types, lights, bg_tex):
    """POLARIS_STX_FORCE: comma-separated feature tokens to force ON.

    Forcing a branch ON is image-identical by the statics invariant (its
    where-predicates stay all-false); it exists so benchmarks can measure a
    machinery's marginal cost with the workload held exactly fixed.
    Tokens: tex:<field>, bxdf:<name>,
    op:<name>, light:<area|env>, bg_tex.
    """
    import os

    spec = os.environ.get("POLARIS_STX_FORCE", "")
    if not spec:
        return tex_fields, ops, bxdf_types, lights, bg_tex
    from .bxdf import (
        BXDF_CONDUCTOR,
        BXDF_DIELECTRIC,
        BXDF_DIFFUSE,
        BXDF_EMISSIVE,
        BXDF_ROUGH_CONDUCTOR,
        BXDF_ROUGH_DIELECTRIC,
    )

    bxdf_bits = {
        "emissive": BXDF_EMISSIVE,
        "diffuse": BXDF_DIFFUSE,
        "conductor": BXDF_CONDUCTOR,
        "rough_conductor": BXDF_ROUGH_CONDUCTOR,
        "dielectric": BXDF_DIELECTRIC,
        "rough_dielectric": BXDF_ROUGH_DIELECTRIC,
    }
    tex_fields, ops, lights = set(tex_fields), set(ops), set(lights)
    bxdf_types = set(bxdf_types)
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok == "bg_tex":
            bg_tex = True
        elif tok.startswith("tex:"):
            tex_fields.add(tok[4:])
        elif tok.startswith("bxdf:"):
            bxdf_types.add(bxdf_bits[tok[5:]])
        elif tok.startswith("op:"):
            ops.add(tok[3:])
        elif tok.startswith("light:"):
            lights.add(tok[6:])
        else:
            raise ValueError(f"unknown POLARIS_STX_FORCE token: {tok!r}")
    return (
        frozenset(tex_fields),
        frozenset(ops),
        frozenset(bxdf_types),
        frozenset(lights),
        bg_tex,
    )


# ----- lookup helpers (None sidecar = no specialization = full program) -----


def tex_on(S, field: str) -> bool:
    stx = S.get("_stx")
    return stx is None or field in stx.tex_fields


def has_bxdf(S, bit: int) -> bool:
    stx = S.get("_stx")
    return stx is None or int(bit) in stx.bxdf_types


def has_op(S, name: str) -> bool:
    stx = S.get("_stx")
    return stx is None or name in stx.ops


def has_light(S, name: str) -> bool:
    stx = S.get("_stx")
    return stx is None or name in stx.lights


def bg_has_tex(S) -> bool:
    stx = S.get("_stx")
    return stx is None or stx.bg_tex
