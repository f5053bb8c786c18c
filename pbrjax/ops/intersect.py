"""Primitive intersection math, backend-agnostic (NumPy / jax.numpy).

Re-implementations of the reference's device intersectors
(``source/opencl/pt_intersect.cl``) as elementwise SoA math:

- Möller-Trumbore ray-triangle (pt_intersect.cl:92-129). We drop the
  reference's ``closeOrigin`` advance-to-node-entry trick (pt_intersect.cl:
  96-97): it mixes t frames between the box and the original origin and is a
  float-precision workaround that would make BVH and brute-force results
  differ; plain f32 MT from the true origin is consistent across both.
- Williams et al. slab ray-AABB test (pt_intersect.cl:11-25).
- Geometric ray-sphere for orb lights (pt_intersect.cl:37-77) — including
  the reference's quirk that the radius parameter is compared against a
  squared distance (``d2 > r``), i.e. it acts as radius²; preserved for
  golden parity.

Everything broadcasts: rays and primitives may each be scalars or batches.
"""

from __future__ import annotations

import numpy as np

from pbrjax.ops.vec import Vec3
from pbrjax.utils.config import EPSILON5

INF = np.float32(np.inf)


def moller_trumbore(xp, o: Vec3, d: Vec3, v0: Vec3, e1: Vec3, e2: Vec3):
    """Ray-triangle intersection.

    Returns ``(t, valid)`` where ``valid`` requires t >= EPSILON5 and
    barycentrics inside the triangle (reference pt_intersect.cl:107-116).
    ``t`` is NOT clamped against a current-best — the caller handles the
    nearest-hit competition so brute force and BVH traversal share one
    tie-breaking rule (first face in memory order wins at equal t).
    """
    tvec = o - v0
    pvec = d.cross(e2)
    qvec = tvec.cross(e1)
    det = e1.dot(pvec)
    inv_det = np.float32(1.0) / det
    t = e2.dot(qvec) * inv_det
    u = tvec.dot(pvec) * inv_det
    v = d.dot(qvec) * inv_det
    valid = (t >= np.float32(EPSILON5)) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, valid


def slab_box(xp, o: Vec3, inv_d: Vec3, bb_min: Vec3, bb_max: Vec3):
    """Ray-AABB slab test (reference intersectBox, pt_intersect.cl:11-25).

    Returns ``(t_near, t_far, hit)`` with hit = (t_near <= t_far). The
    caller applies the reference's extra gates ``t_far > EPSILON5`` and
    ``t_best > t_near`` (pt_bvh.cl:107-110).
    """
    t1 = (bb_min - o) * inv_d
    t2 = (bb_max - o) * inv_d

    # Robustness: a ray lying exactly in a slab plane with zero direction
    # component yields 0 * inf = NaN. IEEE min/max (NumPy, XLA) propagate
    # NaN, which would silently drop real hits (OpenCL's fmin/fmax drop the
    # NaN instead — and even there the reference *misses* boundary-parallel
    # rays). We resolve NaN to "no constraint from this slab" (the origin is
    # on the slab boundary, hence inside it), making the test conservative:
    # the BVH can never miss a hit brute force finds.
    def _mm(a, b, lo):
        m = xp.minimum(a, b) if lo else xp.maximum(a, b)
        return xp.where(m == m, m, np.float32(-np.inf if lo else np.inf))

    t_near = xp.maximum(xp.maximum(_mm(t1.x, t2.x, True), _mm(t1.y, t2.y, True)), _mm(t1.z, t2.z, True))
    t_far = xp.minimum(xp.minimum(_mm(t1.x, t2.x, False), _mm(t1.y, t2.y, False)), _mm(t1.z, t2.z, False))
    return t_near, t_far, t_near <= t_far


def sphere(xp, o: Vec3, d: Vec3, center: Vec3, r_sq):
    """Geometric ray-sphere test (reference intersectSphere,
    pt_intersect.cl:37-77; ``r_sq`` plays the reference's ``r`` role, which
    it de-facto treats as radius²).

    Returns ``(t_near, hit)``.
    """
    L = center - o
    tca = L.dot(d)
    d2 = L.dot(L) - tca * tca
    thc = xp.sqrt(xp.maximum(r_sq - d2, 0.0))
    t0 = tca - thc
    t1 = tca + thc
    # t0 <= t1 by construction (thc >= 0); if t0 < 0 use t1.
    t_near = xp.where(t0 < 0.0, t1, t0)
    hit = (tca >= 0.0) & (d2 <= r_sq) & (t_near >= 0.0)
    return t_near, hit


def gather_vec3(v: Vec3, idx) -> Vec3:
    """Gather a Vec3-of-arrays at integer indices (XLA gather / np fancy
    indexing — the SoA analog of the reference's buffer loads)."""
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def geometric_normal(e1: Vec3, e2: Vec3) -> Vec3:
    """Flat-shading normal = normalize(cross(e1, e2))
    (reference pt_intersect.cl:122)."""
    return e1.cross(e2).normalized()
