"""Face-cluster build for the curved-patch candidate search.

Phong-tessellated scenes (ops/phongtess.py::intersect_clusters_phongtess)
cut the scene into spatially-compact *clusters* of ``size`` faces —
contiguous runs of the main BVH's leaf order, which is a SAH preorder —
and search in two dense stages: a conservative frustum cull of every ray
tile against every cluster AABB (ops/cull.py::candidates_fine), then the
patch intersection of each tile's candidate clusters, near to far.

Host-side NumPy; runs once at scene build.
"""

from __future__ import annotations

import numpy as np

from pbrjax.ops.vec import Vec3
from pbrjax.scene.types import ClusterSet, TrianglesSoA


def build_clusters(
    tris: TrianglesSoA, size: int = 64, face_min=None, face_max=None
) -> ClusterSet:
    """Build a ClusterSet over main-order triangles (already in BVH leaf
    order — scene/build.py permutes before calling).

    ``face_min``/``face_max`` ((F, 3) arrays): optional per-face AABB
    override — Phong-tessellation scenes pass curved-patch-inflated bounds
    (ops/phongtess.py::phongtess_face_aabbs) so cluster AABBs stay
    conservative for the patches. Padding slots of the last cluster hold
    face ids >= F; clusters with no real face keep inverted AABBs
    (min=+inf > max=-inf), which the cull rejects.
    """
    v0 = tris.v0.stack(np).astype(np.float32)
    e1 = tris.e1.stack(np).astype(np.float32)
    e2 = tris.e2.stack(np).astype(np.float32)
    nf = v0.shape[0]
    c = max(1, (nf + size - 1) // size)
    verts = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # (nf, 3, 3)
    f_min = face_min if face_min is not None else verts.min(axis=1)
    f_max = face_max if face_max is not None else verts.max(axis=1)
    bb_min = np.full((c, 3), np.inf, dtype=np.float32)
    bb_max = np.full((c, 3), -np.inf, dtype=np.float32)
    for i in range(c):
        lo, hi = i * size, min((i + 1) * size, nf)
        if hi > lo:
            bb_min[i] = f_min[lo:hi].min(axis=0)
            bb_max[i] = f_max[lo:hi].max(axis=0)
    return ClusterSet(
        bb_min=Vec3(*(bb_min[:, i].copy() for i in range(3))),
        bb_max=Vec3(*(bb_max[:, i].copy() for i in range(3))),
        faces=np.arange(c * size, dtype=np.int32).reshape(c, size),
    )
