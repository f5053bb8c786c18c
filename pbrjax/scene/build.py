"""Scene assembly: parsed model data → renderer-ready SoA pytrees.

The analog of the reference's device-buffer initialization
(``PathTracer::initOpenCLBuffers``, PathTracer.cpp:136-230): triangles are
reordered into BVH-leaf order (PathTracer.cpp:312-330), materials and lights
packed into SoA (PathTracer.cpp:387-428,448-518), and the scene-dependent
constants (sky color from the ``sky_light`` material, light count) surfaced
so the caller can fix them into ``RenderSettings`` — the jit-static
equivalent of the reference's ``#SKY_LIGHT#`` / ``#NUM_LIGHTS#``
substitutions (PathTracer.cpp:209-210,468-474,514-516).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from pbrjax.accel.bvh import build_bvh
from pbrjax.io.lights import lights_to_soa
from pbrjax.io.obj import ObjData
from pbrjax.scene.types import Scene, make_triangles, no_lights, permute_triangles
from pbrjax.utils.config import ACCEL_BVH, BVHConfig, RenderSettings

# Leaf size of the BVH built for scenes above LARGE_SCENE_FACES faces
# (unless the caller passes a BVHConfig). Measured with the XLA walk on an
# H100 at soup:100000, 262,144 bounce rays, nearest hit
# (tools/measure_intersect.py leaf): 4 faces 58.5 ms, 8: 50.0 ms,
# 16: 36.3 ms, 32: 75.2 ms (PERF.md, PR 1). The 20k threshold is not
# re-measured.
LARGE_SCENE_FACES = 20_000
LARGE_SCENE_LEAF = 16


def build_scene(
    obj: ObjData,
    bvh_cfg: Optional[BVHConfig] = None,
    use_bvh: bool = True,
    phong_tess_alpha: float = 0.0,
) -> Scene:
    """Assemble a Scene from parsed OBJ data (host-side, NumPy).

    ``phong_tess_alpha`` > 0 builds the BVH over curved-patch-inflated leaf
    AABBs (thickness + sidedrop, MathHelp.cpp:250-378) so the renderer can
    trace Phong-tessellated patches *through* the tree instead of brute
    force; pass the same alpha as ``RenderSettings.phong_tessellation``.
    """
    tris = make_triangles(
        obj.vertices,
        obj.faces_v,
        obj.normals if obj.normals.size else None,
        obj.faces_vn if obj.faces_vn.size else None,
        obj.faces_mtl,
    )
    bvh = None
    face_min = face_max = None
    if use_bvh:
        v0 = tris.v0.stack(np)
        v1 = (tris.v0 + tris.e1).stack(np)
        v2 = (tris.v0 + tris.e2).stack(np)
        # Scenes above LARGE_SCENE_FACES build LARGE_SCENE_LEAF-face
        # leaves (see the constants). Callers derive the matching
        # traversal bound via ``bvh_max_leaf(scene)``.
        if bvh_cfg is None and tris.count > LARGE_SCENE_FACES:
            cfg = BVHConfig(max_faces=LARGE_SCENE_LEAF)
        else:
            cfg = bvh_cfg or BVHConfig()
        if phong_tess_alpha > 0.0:
            from pbrjax.ops.phongtess import phongtess_face_aabbs

            face_min, face_max = phongtess_face_aabbs(
                v0, v1, v2,
                tris.n0.stack(np), tris.n1.stack(np), tris.n2.stack(np),
                phong_tess_alpha,
            )
        # The native C++ builder is byte-identical to the NumPy one
        # (tests/test_native.py); prefer it when the build is big enough
        # for Python overhead to matter. (It has no inflated-AABB input,
        # so Phong-tess builds use the NumPy builder.)
        bvh = None
        if tris.count >= 4096 and face_min is None:
            try:
                from pbrjax.accel.native import build_bvh_native

                bvh, leaf_order = build_bvh_native(v0, v1, v2, cfg)
            except RuntimeError:
                bvh = None
        if bvh is None:
            bvh, leaf_order, _ = build_bvh(
                v0, v1, v2, cfg, face_min=face_min, face_max=face_max
            )
        tris = permute_triangles(tris, leaf_order)
        if face_min is not None:
            face_min = face_min[leaf_order]
            face_max = face_max[leaf_order]
    clusters = None
    if tris.count > 256 and face_min is not None:
        # Curved-patch candidate tables (accel/clusters.py) for the dense
        # Phong-tess search (ops/phongtess.py::intersect_clusters_phongtess),
        # over the curved-patch-inflated face bounds. Triangles are already
        # in BVH leaf order, so contiguous cluster runs are spatially compact.
        from pbrjax.accel.clusters import build_clusters

        # 128-face clusters above 50k faces (fewer, bigger search steps),
        # 64 below; not re-measured on the GPU yet (PERF.md, open questions).
        clusters = build_clusters(
            tris, size=128 if tris.count > 50_000 else 64,
            face_min=face_min, face_max=face_max,
        )
    materials = obj.mtl.to_soa()
    lights = lights_to_soa(obj.lights) if obj.lights else no_lights()
    return Scene(
        tris=tris, bvh=bvh, materials=materials, lights=lights, clusters=clusters
    )


def bvh_max_leaf(scene: Scene) -> int:
    """The static per-leaf face bound a traversal must unroll for this
    scene's BVH (host-side: call before jit). 2 for BVH-less scenes (the
    reference's compile-time assumption, pt_bvh.cl:35-46)."""
    if scene.bvh is None:
        return 2
    return max(2, int(np.max(np.asarray(scene.bvh.leaf_count))))


def derive_static_flags(scene, settings: RenderSettings) -> RenderSettings:
    """Scene-derived static jit specializations (the reference's
    ``#PLACEHOLDER#`` bake, CL.cpp:626-705, applied at trace time):
    currently ``no_transparency`` when every material is opaque (d == 1 —
    the transmit branch is then statically dead; bitwise-identical
    output, less per-bounce work). Never *unsets* a flag
    the caller pinned."""
    import numpy as np

    if not settings.no_transparency:
        d = np.asarray(scene.materials.d)
        if d.size == 0 or bool((d >= 1.0).all()):
            settings = settings.replace(no_transparency=True)
    return settings


def apply_scene_constants(settings: RenderSettings, obj: ObjData) -> RenderSettings:
    """Fix scene-derived static settings: sky color from the ``sky_light``
    material (white fallback, PathTracer.cpp:514-516) and shadow-ray
    disabling when the scene has no lights (LightParser.cpp:116-121)."""
    sky = obj.mtl.sky_light()
    kw = {}
    if sky is not None:
        kw["sky_light"] = tuple(float(c) for c in sky)
    if not obj.lights and settings.shadow_rays:
        kw["shadow_rays"] = 0
    return settings.replace(**kw) if kw else settings


def scene_from_text(
    obj_text: str,
    mtl_text: str = "",
    lights_text: str = "",
    bvh_cfg: Optional[BVHConfig] = None,
    use_bvh: bool = True,
    phong_tess_alpha: float = 0.0,
) -> Tuple[Scene, ObjData]:
    """Build a scene directly from OBJ/MTL/.lights text (procedural scenes
    and tests)."""
    from pbrjax.io.lights import parse_lights
    from pbrjax.io.mtl import parse_mtl
    from pbrjax.io.obj import parse_obj

    mtl = parse_mtl(mtl_text) if mtl_text else None
    lights = parse_lights(lights_text) if lights_text else []
    obj = parse_obj(obj_text, mtl=mtl, lights=lights)
    return (
        build_scene(
            obj, bvh_cfg=bvh_cfg, use_bvh=use_bvh, phong_tess_alpha=phong_tess_alpha
        ),
        obj,
    )


def to_device(scene: Scene):
    """Move a host (NumPy) scene onto the default JAX device(s) as one
    pytree. Sharding-aware placement lives in ``pbrjax.parallel``."""
    import jax

    return jax.tree_util.tree_map(jax.numpy.asarray, scene)
