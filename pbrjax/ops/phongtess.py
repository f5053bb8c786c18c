"""Phong-tessellation patch intersection (optional feature).

Vectorized re-derivation of the reference's curved-patch intersector
(``pt_phongtess.cl``, after "Direct Ray Tracing of Phong Tessellation",
Ogaki & Tokuyoshi — cited at pt_intersect.cl:170): triangles whose vertex
normals differ are treated as quadratic Phong patches controlled by
``alpha`` (config ``render.phong_tessellation``); the ray is converted to
two Hesse-form planes (pt_utils.cl:208-218), the patch intersection reduces
to a cubic in one plane parameter then quadratics in a barycentric
coordinate, with a Newton polish on every root (pt_utils.cl:108-199
solveCubic).

Everything is elementwise over ray batches with masks replacing the
reference's scalar early-outs; the per-face scalar loop mirrors
``intersect_brute``. Off by default — the reference ships it disabled
(config.json:102-105) and its CHANGELOG notes artifacts; it is numerically
the most delicate kernel (SURVEY.md §7 "Hard parts").
"""

from __future__ import annotations

import numpy as np

from pbrjax.ops.intersect import INF, moller_trumbore
from pbrjax.ops.vec import Vec3, project_on_plane, safe_normalized, where3
from pbrjax.scene.types import TrianglesSoA
from pbrjax.utils.config import EPSILON5

F32 = np.float32
_THIRD = F32(1.0 / 3.0)
_THIRD_HALF = F32(1.0 / 6.0)


def _guard_div(xp, num, den):
    ok = den != 0.0
    return xp.where(ok, num / xp.where(ok, den, F32(1.0)), F32(0.0))


def solve_cubic(xp, a0, a1, a2, a3):
    """Vectorized solveCubic (pt_utils.cl:108-199): roots of
    a0 x³ + a1 x² + a2 x + a3 = 0 with Newton polish.

    Returns ``(x0, x1, x2, count)``; only the first ``count`` slots are
    meaningful (count in {0,1,2,3}).
    """
    with np.errstate(all="ignore") if xp is np else _null():
        # --- cubic branch -------------------------------------------------
        w = _guard_div(xp, a1, a0) * _THIRD
        p_lin = _guard_div(xp, a2, a0) * _THIRD - w * w
        p = p_lin * p_lin * p_lin
        q = F32(0.5) * _guard_div(xp, a2 * w - a3, a0) - w * w * w
        dis = q * q + p

        # three real roots (dis < 0); reference computes q / sqrt(-p)
        phi = xp.arccos(xp.clip(_guard_div(xp, q, xp.sqrt(xp.maximum(-p, 0.0))), -1.0, 1.0))
        pp = 2.0 * xp.power(xp.maximum(-p, 0.0), _THIRD_HALF)
        u0 = pp * xp.cos(phi * _THIRD) - w
        u1 = pp * xp.cos((phi + F32(2.0 * np.pi)) * _THIRD) - w
        u2 = pp * xp.cos((phi + F32(4.0 * np.pi)) * _THIRD) - w
        c_x0 = xp.minimum(u0, xp.minimum(u1, u2))
        c_x2 = xp.maximum(u0, xp.maximum(u1, u2))
        c_x1 = xp.maximum(
            xp.minimum(u0, u1),
            xp.maximum(xp.minimum(u0, u2), xp.minimum(u1, u2)),
        )

        def newton3(x):
            num = a3 + x * (a2 + x * (a1 + x * a0))
            den = a2 + x * (2.0 * a1 + x * 3.0 * a0)
            return x - _guard_div(xp, num, den)

        c_x0, c_x1, c_x2 = newton3(c_x0), newton3(c_x1), newton3(c_x2)

        # single real root (dis >= 0)
        sq = xp.sqrt(xp.maximum(dis, 0.0))
        s_x0 = newton3(xp.cbrt(q + sq) + xp.cbrt(q - sq) - w)

        # --- quadratic branch --------------------------------------------
        pq = F32(0.5) * _guard_div(xp, a2, a1)
        qdis = pq * pq - _guard_div(xp, a3, a1)
        qs = xp.sqrt(xp.maximum(qdis, 0.0))

        def newton2(x):
            num = a3 + x * (a2 + x * a1)
            den = a2 + x * 2.0 * a1
            return x - _guard_div(xp, num, den)

        q_x0 = newton2(-pq - qs)
        q_x1 = newton2(-pq + qs)

        # --- linear branch ------------------------------------------------
        l_x0 = _guard_div(xp, -a3, a2)

        is_cubic = xp.abs(a0) > 0.0
        is_quad = ~is_cubic & (xp.abs(a1) > 0.0)
        is_lin = ~is_cubic & ~is_quad & (xp.abs(a2) > 0.0)
        three = is_cubic & (dis < 0.0)
        one_c = is_cubic & ~three
        two_q = is_quad & (qdis >= 0.0)

        x0 = xp.where(
            three, c_x0, xp.where(one_c, s_x0, xp.where(two_q, q_x0, l_x0))
        )
        x1 = xp.where(three, c_x1, xp.where(two_q, q_x1, F32(-1.0)))
        x2 = xp.where(three, c_x2, F32(-1.0))
        count = (
            xp.where(three, 3, 0)
            + xp.where(one_c, 1, 0)
            + xp.where(two_q, 2, 0)
            + xp.where(is_lin, 1, 0)
        ).astype(xp.int32)
        return x0, x1, x2, count


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _ray_planes(xp, o: Vec3, d: Vec3):
    """Two planes intersecting in the ray (getPlanesFromRay,
    pt_utils.cl:208-218)."""
    n1 = safe_normalized(o.cross(d))
    n2 = safe_normalized(n1.cross(d))
    return n1, n2, n1.dot(o), n2.dot(o)


def _axis_component(xp, v: Vec3, domain):
    """v[domain] per-lane (getBestRayDomain consumer, pt_phongtess.cl:196)."""
    return xp.where(domain == 0, v.x, xp.where(domain == 1, v.y, v.z))


def phongtess_patch_intersect(
    xp, o: Vec3, d: Vec3, P1: Vec3, P2: Vec3, P3: Vec3, N1: Vec3, N2: Vec3, N3: Vec3,
    alpha, t_best, t_near=None, t_far=None,
):
    """Ray vs one Phong patch (phongTessTriAndRayIntersect,
    pt_phongtess.cl:56-212), elementwise over the ray batch.

    Returns ``(t, u, v, valid)`` — the nearest acceptable root with
    t in [|t_near|, min(t_best, t_far)].
    """
    if t_near is None:
        t_near = F32(0.0)
    if t_far is None:
        t_far = INF

    E01 = P2 - P1
    E12 = P3 - P2
    E20 = P1 - P3
    C1 = (N2 * N2.dot(E01) - N1 * N1.dot(E01)) * alpha
    C2 = (N3 * N3.dot(E12) - N2 * N2.dot(E12)) * alpha
    C3 = (N1 * N1.dot(E20) - N3 * N3.dot(E20)) * alpha

    n1, n2, o1, o2 = _ray_planes(xp, o, d)
    a = (-n1).dot(C3)
    b = (-n1).dot(C2)
    c = n1.dot(P3) - o1
    dd = n1.dot(C1 - C2 - C3) * F32(0.5)
    e = n1.dot(C3 + E20) * F32(0.5)
    f = n1.dot(C2 - E12) * F32(0.5)
    l = (-n2).dot(C3)
    m = (-n2).dot(C2)
    n_ = n2.dot(P3) - o2
    o_ = n2.dot(C1 - C2 - C3) * F32(0.5)
    p = n2.dot(C3 + E20) * F32(0.5)
    q = n2.dot(C2 - E12) * F32(0.5)

    a3c = (l * m * n_ + 2.0 * o_ * p * q) - (l * q * q + m * p * p + n_ * o_ * o_)
    a2c = (a * m * n_ + l * b * n_ + l * m * c + 2.0 * (dd * p * q + o_ * e * q + o_ * p * f)) - (
        a * q * q + b * p * p + c * o_ * o_ + 2.0 * (l * f * q + m * e * p + n_ * dd * o_)
    )
    a1c = (a * b * n_ + a * m * c + l * b * c + 2.0 * (o_ * e * f + dd * e * q + dd * p * f)) - (
        l * f * f + m * e * e + n_ * dd * dd + 2.0 * (a * f * q + b * e * p + c * dd * o_)
    )
    a0c = (a * b * c + 2.0 * dd * e * f) - (a * f * f + b * e * e + c * dd * dd)

    # Reference naming (pt_phongtess.cl:99-106): their "a0" is the x³
    # coefficient and "a3" the constant; solveCubic takes highest first.
    x0, x1, x2, count = solve_cubic(xp, a0c, a1c, a2c, a3c)
    any_roots = count > 0

    # Pick x minimizing mD² - mA·mB (sequential strict-greater update,
    # pt_phongtess.cl:117-125).
    x = xp.zeros_like(a)
    determinant = xp.full_like(a, INF)
    for i, xi in enumerate((x0, x1, x2)):
        mA = a * xi + l
        mB = b * xi + m
        mD = dd * xi + o_
        tmp = mD * mD - mA * mB
        use = (i < count) & (determinant > tmp)
        x = xp.where(use, xi, x)
        determinant = xp.where(use, tmp, determinant)
    ok = any_roots & (determinant > 0.0)

    dabs = Vec3(xp.abs(d.x), xp.abs(d.y), xp.abs(d.z))
    domain = xp.where(dabs.y > dabs.z, 1, 2).astype(xp.int32)
    domain = xp.where(
        (dabs.x > dabs.y), xp.where(dabs.x > dabs.z, 0, 2).astype(xp.int32), domain
    )

    mA = a * x + l
    mB = b * x + m
    mC = c * x + n_
    mD = dd * x + o_
    mE = e * x + p
    mF = f * x + q
    a_less_b = xp.abs(mA) < xp.abs(mB)
    mBorA = xp.where(a_less_b, mB, mA)
    inv = _guard_div(xp, xp.ones_like(mBorA), mBorA)
    mA, mB, mC, mD, mE, mF = (v * inv for v in (mA, mB, mC, mD, mE, mF))

    mAorB = xp.where(a_less_b, mA, mB)
    mEorF = xp.where(a_less_b, 2.0 * mE, 2.0 * mF)
    mForE = xp.where(a_less_b, mF, mE)
    ab = xp.where(a_less_b, a, b)
    ba = xp.where(a_less_b, b, a)
    ef = xp.where(a_less_b, e, f)
    fe = xp.where(a_less_b, f, e)

    sqrtAorB = xp.sqrt(xp.maximum(mD * mD - mAorB, 0.0))
    sqrtC = xp.sqrt(xp.maximum(mForE * mForE - mC, 0.0))
    lab1 = mD + sqrtAorB
    lab2 = mD - sqrtAorB
    lc1 = mForE + sqrtC
    lc2 = mForE - sqrtC
    # The factored product's u-coefficient is the CROSS pairing
    # lab1*lc2 + lab2*lc1; if the same-index pairing matches mEorF better,
    # the lc labels are crossed — swap (pt_phongtess.cl:166-168).
    swap_lc = xp.abs(mEorF - lab1 * lc1 - lab2 * lc2) < xp.abs(
        mEorF - lab1 * lc2 - lab2 * lc1
    )
    lc1, lc2 = (
        xp.where(swap_lc, lc2, lc1),
        xp.where(swap_lc, lc1, lc2),
    )

    t_out = xp.full_like(a, INF)
    u_out = xp.zeros_like(a)
    v_out = xp.zeros_like(a)
    for loop in range(2):
        g = -lab1 if loop == 0 else -lab2
        h = -lc1 if loop == 0 else -lc2
        c0 = ab + g * (2.0 * dd + ba * g)
        c1 = 2.0 * (h * (dd + ba * g) + ef + fe * g)
        c2 = h * (ba * h + 2.0 * fe) + c
        r0, r1, _, rcount = solve_cubic(xp, xp.zeros_like(c0), c0, c1, c2)
        for i, u in enumerate((r0, r1)):
            v = g * u + h
            wbar = 1.0 - u - v
            root_ok = ok & (i < rcount) & (u >= 0.0) & (v >= 0.0) & (wbar >= 0.0)
            uu = xp.where(a_less_b, u, v)
            vv = xp.where(a_less_b, v, u)
            # tessellated point (phongTessellation, pt_phongtess.cl:14-26)
            ww = 1.0 - uu - vv
            p_bary = P1 * uu + P2 * vv + P3 * ww
            p_tess = (
                project_on_plane(p_bary, P1, N1) * uu
                + project_on_plane(p_bary, P2, N2) * vv
                + project_on_plane(p_bary, P3, N3) * ww
            )
            pt = p_bary * (1.0 - alpha) + p_tess * alpha - o
            t_param = _guard_div(
                xp, _axis_component(xp, pt, domain), _axis_component(xp, d, domain)
            )
            accept = (
                root_ok
                & (t_param >= xp.abs(t_near))
                & (t_param <= xp.minimum(t_out, xp.minimum(t_best, t_far)))
            )
            t_out = xp.where(accept, t_param, t_out)
            u_out = xp.where(accept, uu, u_out)
            v_out = xp.where(accept, vv, v_out)

    return t_out, u_out, v_out, xp.isfinite(t_out)


def phongtess_normal(
    xp, d: Vec3, N1: Vec3, N2: Vec3, N3: Vec3, C1: Vec3, C2: Vec3, C3: Vec3,
    E12: Vec3, E20: Vec3, u, v,
) -> Vec3:
    """Patch shading normal (getPhongTessNormal, pt_utils.cl:282-294):
    surface-derivative normal unless it back-faces the reflection of the
    smooth normal."""
    w = 1.0 - u - v
    du = C3 * (w - u) + (C1 - C2) * v + E20
    dv = C2 * (w - v) + (C1 - C3) * u - E12
    ns = safe_normalized(du.cross(dv))
    npn = safe_normalized(N1 * u + N2 * v + N3 * w)
    r = d - npn * (2.0 * npn.dot(d))
    return where3(ns.dot(r) < 0.0, ns, npn)


def patch_constants(P1, P2, P3, N1, N2, N3, alpha):
    """(C1, C2, C3, E12, E20) for the normal evaluation."""
    E01 = P2 - P1
    E12 = P3 - P2
    E20 = P1 - P3
    C1 = (N2 * N2.dot(E01) - N1 * N1.dot(E01)) * alpha
    C2 = (N3 * N3.dot(E12) - N2 * N2.dot(E12)) * alpha
    C3 = (N1 * N1.dot(E20) - N3 * N3.dot(E20)) * alpha
    return C1, C2, C3, E12, E20


def _tess_point(p1, p2, p3, n1, n2, n3, alpha, u, v):
    """Vectorized MathHelp::phongTessellate (MathHelp.cpp:213-226) on
    (F, 3) NumPy arrays; ``u``/``v`` are scalars or (F, 1) arrays."""
    dot = lambda a, b: np.sum(a * b, axis=-1, keepdims=True)  # noqa: E731
    proj = lambda q, p, n: q - dot(q - p, n) * n  # noqa: E731
    w = 1.0 - u - v
    p_bary = p1 * u + p2 * v + p3 * w
    p_tess = (
        proj(p_bary, p1, n1) * u + proj(p_bary, p2, n2) * v + proj(p_bary, p3, n3) * w
    )
    return (1.0 - alpha) * p_bary + alpha * p_tess


def phongtess_face_aabbs(p1, p2, p3, n1, n2, n3, alpha):
    """Per-face AABBs inflated to cover the curved Phong patch — the
    build-time bound that lets curved patches trace *through* the BVH (the
    reference's triCalcAABB / triThicknessAndSidedrop, MathHelp.cpp:250-378).

    Deliberate improvement over the reference: its bound samples the patch
    at one interior extremum + nine fixed (u,v) sidedrop points, which is
    NOT conservative — the patch can escape between samples (consistent with
    the artifacts its CHANGELOG notes). The Phong-tessellated surface is
    exactly a quadratic Bézier triangle: with c = (u, v, w) barycentrics,
    p(c) = Σᵢ cᵢ² pᵢ + Σ_{i<j} cᵢcⱼ q_ij where
    q_ij = (1-α)(pᵢ+pⱼ) + α(πᵢ(pⱼ) + πⱼ(pᵢ)) and πᵢ is the (affine)
    projection onto vertex i's tangent plane. In Bernstein form the six
    control points are {p₁, p₂, p₃, q₁₂/2, q₂₃/2, q₁₃/2}; Bernstein weights
    are a nonneg partition of unity, so the control points' AABB *provably*
    contains the patch — and it is cheaper than the reference's 13
    tessellation evaluations. Faces whose vertex normals agree (within the
    reference's 1e-6 test, MathHelp.cpp:281-289) keep the flat AABB.

    Inputs: (F, 3) float arrays. Returns ``(bb_min, bb_max)`` (F, 3) f32.
    """
    p1 = np.asarray(p1, dtype=np.float32)
    p2 = np.asarray(p2, dtype=np.float32)
    p3 = np.asarray(p3, dtype=np.float32)
    n1 = np.asarray(n1, dtype=np.float32)
    n2 = np.asarray(n2, dtype=np.float32)
    n3 = np.asarray(n3, dtype=np.float32)
    alpha = np.float32(alpha)
    dot = lambda a, b: np.sum(a * b, axis=-1, keepdims=True)  # noqa: E731
    proj = lambda q, p, n: q - dot(q - p, n) * n  # noqa: E731

    bb_min = np.minimum(np.minimum(p1, p2), p3)
    bb_max = np.maximum(np.maximum(p1, p2), p3)

    test = (n1 - n2) + (n2 - n3)
    curved = np.any(np.abs(test) > 1e-6, axis=-1, keepdims=True)
    if alpha <= 0.0 or not curved.any():
        return bb_min, bb_max

    with np.errstate(all="ignore"):
        grow_min, grow_max = bb_min.copy(), bb_max.copy()
        for (pa, na), (pb, nb) in (
            ((p1, n1), (p2, n2)),
            ((p2, n2), (p3, n3)),
            ((p1, n1), (p3, n3)),
        ):
            q = (1.0 - alpha) * (pa + pb) + alpha * (proj(pb, pa, na) + proj(pa, pb, nb))
            b = np.float32(0.5) * q  # mid-edge Bézier control point
            grow_min = np.minimum(grow_min, b)
            grow_max = np.maximum(grow_max, b)

    bb_min = np.where(curved, grow_min, bb_min)
    bb_max = np.where(curved, grow_max, bb_max)
    return bb_min.astype(np.float32), bb_max.astype(np.float32)


def face_is_flat(xp, tris: TrianglesSoA):
    """Per-face flag: all three vertex normals equal (checkFaceIntersection,
    pt_intersect.cl:151-165) — flat faces use plain Möller-Trumbore."""
    eq = lambda a, b: (a.x == b.x) & (a.y == b.y) & (a.z == b.z)  # noqa: E731
    return eq(tris.n0, tris.n1) & eq(tris.n1, tris.n2)


def _face_vec(v: Vec3, f: int) -> Vec3:
    return Vec3(v.x[f], v.y[f], v.z[f])


def intersect_bvh_phongtess(
    xp, o: Vec3, d: Vec3, bvh, tris: TrianglesSoA, alpha, max_leaf: int = 2
):
    """Nearest-hit via the stackless BVH with per-face flat/curved dispatch
    (the reference's shared leaf test, pt_intersect.cl:142-176, reached
    through traverse, pt_bvh.cl:82-123). Same contract and tie-breaking as
    ``intersect_brute_phongtess`` — the BVH must have been built with
    ``phongtess_face_aabbs`` inflation or curved hits outside the flat
    triangle bounds would be culled.

    Returns ``(t, face, u, v)``.
    """
    from pbrjax.ops.intersect import gather_vec3, slab_box

    n = bvh.count
    nf = int(tris.mtl.shape[0])
    inv_d = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    flat = face_is_flat(xp, tris)

    idx0 = xp.full_like(o.x, 0, dtype=xp.int32)
    t0 = xp.full_like(o.x, INF)
    f0 = xp.full_like(o.x, -1, dtype=xp.int32)
    u0 = xp.zeros_like(o.x)
    v0_ = xp.zeros_like(o.x)

    def step(state):
        idx, t_best, f_best, u_best, v_best = state
        safe = xp.minimum(idx, n - 1)
        bb_min = gather_vec3(bvh.bb_min, safe)
        bb_max = gather_vec3(bvh.bb_max, safe)
        leaf_first = bvh.leaf_first[safe]
        leaf_count = bvh.leaf_count[safe]
        exit_i = bvh.exit[safe]

        t_near, t_far, hit_box = slab_box(xp, o, inv_d, bb_min, bb_max)
        hit_box = hit_box & (t_far > F32(EPSILON5)) & (t_best > t_near)
        do_leaf = hit_box & (leaf_first >= 0)

        for k in range(max_leaf):
            fidx = xp.clip(leaf_first + k, 0, nf - 1)
            P1 = Vec3(tris.v0.x[fidx], tris.v0.y[fidx], tris.v0.z[fidx])
            e1 = Vec3(tris.e1.x[fidx], tris.e1.y[fidx], tris.e1.z[fidx])
            e2 = Vec3(tris.e2.x[fidx], tris.e2.y[fidx], tris.e2.z[fidx])
            t_f, valid_f = moller_trumbore(xp, o, d, P1, e1, e2)
            N1 = Vec3(tris.n0.x[fidx], tris.n0.y[fidx], tris.n0.z[fidx])
            N2 = Vec3(tris.n1.x[fidx], tris.n1.y[fidx], tris.n1.z[fidx])
            N3 = Vec3(tris.n2.x[fidx], tris.n2.y[fidx], tris.n2.z[fidx])
            t_c, uu, vv, valid_c = phongtess_patch_intersect(
                xp, o, d, P1, P1 + e1, P1 + e2, N1, N2, N3, alpha, t_best
            )
            is_flat = flat[fidx]
            t = xp.where(is_flat, t_f, t_c)
            valid = xp.where(is_flat, valid_f, valid_c & (t_c >= F32(EPSILON5)))
            uu = xp.where(is_flat, xp.zeros_like(uu), uu)
            vv = xp.where(is_flat, xp.zeros_like(vv), vv)
            better = do_leaf & (k < leaf_count) & valid & (t < t_best)
            t_best = xp.where(better, t, t_best)
            f_best = xp.where(better, fidx.astype(xp.int32), f_best)
            u_best = xp.where(better, uu, u_best)
            v_best = xp.where(better, vv, v_best)

        nxt = xp.where(hit_box, safe + 1, exit_i)
        idx = xp.where(idx >= n, n, nxt).astype(xp.int32)
        return idx, t_best, f_best, u_best, v_best

    state = (idx0, t0, f0, u0, v0_)
    if xp.__name__.startswith("jax"):
        import jax

        return jax.lax.while_loop(
            lambda s: xp.any(s[0] < n), step, state
        )[1:]
    with np.errstate(all="ignore"):
        while np.any(state[0] < n):
            state = step(state)
    return state[1:]


def intersect_scene_phongtess(
    xp, o: Vec3, d: Vec3, scene, alpha, max_leaf: int = 2, alive=None
):
    """Phong-tess nearest-hit dispatch: the cluster-candidate dense search
    (jax + large batches, scenes with a ClusterSet built over inflated
    AABBs), the BVH walk when the scene has one, brute sweep otherwise.
    Returns ``(t, face, u, v)``.

    Differentiability contract (mirrors ``intersect_scene``): the BVH search
    runs detached (while_loop has no reverse mode), then the winner's ``t``
    is re-evaluated differentiably — Möller-Trumbore for flat winners, the
    tessellated-point/domain formula for curved ones (bitwise the same
    forward value the search produced, since it is the same expression on
    the same inputs). Gradients w.r.t. o and d flow through the re-eval;
    geometry and the patch (u, v) are detached (detached-sampling policy).
    """
    from pbrjax.ops.intersect import gather_vec3

    if scene.bvh is None:
        return intersect_brute_phongtess(xp, o, d, scene.tris, alpha)

    is_jax = xp.__name__.startswith("jax")
    o_s, d_s = o, d
    if is_jax:
        import jax

        sg = jax.lax.stop_gradient
        o_s = Vec3(sg(o.x), sg(o.y), sg(o.z))
        d_s = Vec3(sg(d.x), sg(d.y), sg(d.z))
    if is_jax and scene.clusters is not None and o.x.size >= 4096:
        import jax

        tris_sg = jax.tree_util.tree_map(jax.lax.stop_gradient, scene.tris)
        face, uu, vv = intersect_clusters_phongtess(
            xp, o_s, d_s, scene.clusters, tris_sg, alpha, alive=alive
        )
    else:
        _, face, uu, vv = intersect_bvh_phongtess(
            xp, o_s, d_s, scene.bvh, scene.tris, alpha, max_leaf=max_leaf
        )

    tris = scene.tris
    if is_jax:
        import jax

        tris = jax.tree_util.tree_map(jax.lax.stop_gradient, tris)
        uu = jax.lax.stop_gradient(uu)
        vv = jax.lax.stop_gradient(vv)
    safe = xp.maximum(face, 0)
    P1 = gather_vec3(tris.v0, safe)
    e1 = gather_vec3(tris.e1, safe)
    e2 = gather_vec3(tris.e2, safe)
    t_f, _ = moller_trumbore(xp, o, d, P1, e1, e2)

    N1 = gather_vec3(tris.n0, safe)
    N2 = gather_vec3(tris.n1, safe)
    N3 = gather_vec3(tris.n2, safe)
    P2 = P1 + e1
    P3 = P1 + e2
    ww = 1.0 - uu - vv
    p_bary = P1 * uu + P2 * vv + P3 * ww
    p_tess = (
        project_on_plane(p_bary, P1, N1) * uu
        + project_on_plane(p_bary, P2, N2) * vv
        + project_on_plane(p_bary, P3, N3) * ww
    )
    pt = p_bary * (1.0 - alpha) + p_tess * alpha - o
    dabs = Vec3(xp.abs(d_s.x), xp.abs(d_s.y), xp.abs(d_s.z))
    domain = xp.where(dabs.y > dabs.z, 1, 2).astype(xp.int32)
    domain = xp.where(
        (dabs.x > dabs.y), xp.where(dabs.x > dabs.z, 0, 2).astype(xp.int32), domain
    )
    t_c = _guard_div(
        xp, _axis_component(xp, pt, domain), _axis_component(xp, d, domain)
    )

    flat_w = face_is_flat(xp, tris)[safe]
    t = xp.where(flat_w, t_f, t_c)
    t = xp.where(face >= 0, t, INF)
    return t, face, uu, vv


def intersect_brute_phongtess(xp, o: Vec3, d: Vec3, tris: TrianglesSoA, alpha):
    """Nearest-hit over all faces with Phong tessellation for curved faces
    (vertex normals differ) and Möller-Trumbore for flat ones. Returns
    ``(t, face, u, v)`` — u/v are patch coordinates for curved winners
    (0 for flat)."""
    flat = face_is_flat(xp, tris)
    nf = int(tris.mtl.shape[0])
    t_best = xp.full_like(o.x, INF)
    f_best = xp.full_like(o.x, -1, dtype=xp.int32)
    u_best = xp.zeros_like(o.x)
    v_best = xp.zeros_like(o.x)
    for f in range(nf):
        P1 = _face_vec(tris.v0, f)
        e1 = _face_vec(tris.e1, f)
        e2 = _face_vec(tris.e2, f)
        P2 = P1 + e1
        P3 = P1 + e2
        # Flatness is data (traced); evaluate both intersectors for the
        # face and select — the feature is opt-in, so the 2x face cost only
        # applies when phong_tessellation > 0 (like the reference paying
        # the PHONGTESS compile-time specialization, pt_intersect.cl:151).
        t_f, valid_f = moller_trumbore(xp, o, d, P1, e1, e2)
        N1 = _face_vec(tris.n0, f)
        N2 = _face_vec(tris.n1, f)
        N3 = _face_vec(tris.n2, f)
        t_c, uu, vv, valid_c = phongtess_patch_intersect(
            xp, o, d, P1, P2, P3, N1, N2, N3, alpha, t_best
        )
        is_flat = flat[f]
        t = xp.where(is_flat, t_f, t_c)
        valid = xp.where(is_flat, valid_f, valid_c & (t_c >= F32(EPSILON5)))
        uu = xp.where(is_flat, xp.zeros_like(uu), uu)
        vv = xp.where(is_flat, xp.zeros_like(vv), vv)
        better = valid & (t < t_best)
        t_best = xp.where(better, t, t_best)
        f_best = xp.where(better, xp.int32(f), f_best)
        u_best = xp.where(better, uu, u_best)
        v_best = xp.where(better, vv, v_best)
    return t_best, f_best, u_best, v_best


def intersect_clusters_phongtess(
    xp, o: Vec3, d: Vec3, cset, tris: TrianglesSoA, alpha,
    alive=None, tile: int = 128, chunk_rays: int = 16384,
):
    """Detached nearest-hit SEARCH over cluster candidates with mixed
    flat/curved (Phong-patch) faces for ``phong_tessellation > 0`` (jax
    only). Returns ``(face, u, v)``.

    Plain XLA in two dense stages (the patch pipeline — two cubic solves
    with Newton polish per face — is ~10x the ALU work of
    Möller-Trumbore): the cull stage (ops/cull.py, cluster AABBs inflated
    at build — accel/clusters.py face_min/face_max) yields near-to-far
    candidate lists; a device-side while loop processes one cluster per
    tile per round, evaluating all ``size`` member faces against all
    ``tile`` rays densely (patch intersect for curved faces, MT for
    flat), with an entry-bound early-out and exact (t, face)-lexicographic
    minima.

    ``alive``: dead lanes keep their rays (tight tiles) but are seeded
    closed and report face = -1.
    """
    import jax
    import jax.numpy as jnp

    from pbrjax.ops.cull import candidates_fine

    alpha = F32(alpha)
    s = cset.size
    c = cset.count
    shape = o.x.shape
    flat_n = int(np.prod(shape)) if shape else 1
    chunk = min(
        max(tile, (chunk_rays // tile) * tile), -(-flat_n // tile) * tile
    )
    pad = (-flat_n) % chunk
    total = flat_n + pad
    n_chunks = total // chunk
    n_tiles = chunk // tile

    def prep(a, mode="edge"):
        a = a.reshape(-1)
        if pad:
            a = jnp.pad(a, (0, pad), mode=mode)
        return a

    ox, oy, oz = prep(o.x), prep(o.y), prep(o.z)
    dx, dy, dz = prep(d.x), prep(d.y), prep(d.z)
    if alive is None:
        alive_f = jnp.ones((total,), dtype=bool)
    else:
        alive_f = prep(alive.astype(jnp.int32)) != 0
    if pad:
        alive_f = alive_f.at[flat_n:].set(False)

    flat_flags = face_is_flat(jnp, tris)
    nf_pad = c * s
    fpad = nf_pad - int(tris.mtl.shape[0])

    def fpadded(a, fill=0.0):
        return jnp.pad(a, (0, fpad), constant_values=fill) if fpad else a

    fields = {
        "v0x": fpadded(tris.v0.x), "v0y": fpadded(tris.v0.y), "v0z": fpadded(tris.v0.z),
        "e1x": fpadded(tris.e1.x), "e1y": fpadded(tris.e1.y), "e1z": fpadded(tris.e1.z),
        "e2x": fpadded(tris.e2.x), "e2y": fpadded(tris.e2.y), "e2z": fpadded(tris.e2.z),
        "n0x": fpadded(tris.n0.x), "n0y": fpadded(tris.n0.y), "n0z": fpadded(tris.n0.z),
        "n1x": fpadded(tris.n1.x), "n1y": fpadded(tris.n1.y), "n1z": fpadded(tris.n1.z),
        "n2x": fpadded(tris.n2.x), "n2y": fpadded(tris.n2.y), "n2z": fpadded(tris.n2.z),
        # Padding faces are flat with zero edges: MT det = 0, never valid.
        "flat": fpadded(flat_flags.astype(jnp.float32), fill=1.0),
    }

    _BIGN = np.float32(-3.0e38)

    def chunk_fn(args):
        ox, oy, oz, dx, dy, dz, alive_c = args
        ov = Vec3(ox, oy, oz)
        dv = Vec3(dx, dy, dz)
        cand, cnt, tent = candidates_fine(jnp, ov, dv, cset, tile)
        tent = jnp.concatenate(
            [tent, jnp.full((n_tiles, 1), np.float32(3.0e38))], axis=1
        )
        o3 = Vec3(*(a.reshape(n_tiles, tile, 1) for a in (ox, oy, oz)))
        d3 = Vec3(*(a.reshape(n_tiles, tile, 1) for a in (dx, dy, dz)))

        t0 = jnp.where(alive_c, INF, _BIGN).reshape(n_tiles, tile)
        f0 = jnp.full((n_tiles, tile), -1, jnp.int32)
        u0 = jnp.zeros((n_tiles, tile), jnp.float32)

        def tiles_done(r, t_b):
            tent_r = jax.lax.dynamic_slice_in_dim(tent, r, 1, 1)[:, 0]
            return (cnt <= r) | (jnp.max(t_b, axis=1) <= tent_r)

        def cond(carry):
            r = carry[0]
            return (r < np.int32(c)) & ~jnp.all(tiles_done(r, carry[1]))

        def body(carry):
            r, t_b, f_b, u_b, v_b = carry
            cid = jax.lax.dynamic_slice_in_dim(cand, r, 1, 1)[:, 0]  # (T,)
            fids = cset.faces[cid]  # (T, S) member face ids
            g = {k: v[fids][:, None, :] for k, v in fields.items()}  # (T,1,S)
            P1 = Vec3(g["v0x"], g["v0y"], g["v0z"])
            E1 = Vec3(g["e1x"], g["e1y"], g["e1z"])
            E2 = Vec3(g["e2x"], g["e2y"], g["e2z"])
            P2 = P1 + E1
            P3 = P1 + E2
            N1 = Vec3(g["n0x"], g["n0y"], g["n0z"])
            N2 = Vec3(g["n1x"], g["n1y"], g["n1z"])
            N3 = Vec3(g["n2x"], g["n2y"], g["n2z"])
            t_mt, ok_mt = moller_trumbore(xp, o3, d3, P1, E1, E2)
            t_pt, u_pt, v_pt, ok_pt = phongtess_patch_intersect(
                xp, o3, d3, P1, P2, P3, N1, N2, N3, alpha,
                t_best=t_b[:, :, None],
            )
            is_flat = g["flat"] > 0.5
            tt = jnp.where(is_flat, jnp.where(ok_mt, t_mt, INF),
                           jnp.where(ok_pt, t_pt, INF))
            uu = jnp.where(is_flat, 0.0, u_pt)
            vv = jnp.where(is_flat, 0.0, v_pt)
            # Lexicographic (t, face-id) minimum over the cluster's faces.
            k = jnp.argmin(tt, axis=2)  # first minimal face (ties)
            take = lambda a: jnp.take_along_axis(a, k[:, :, None], 2)[:, :, 0]
            tmin = take(tt)
            fid = jnp.take_along_axis(
                jnp.broadcast_to(fids[:, None, :], tt.shape), k[:, :, None], 2
            )[:, :, 0]
            umin = take(uu)
            vmin = take(vv)
            better = (tmin < INF) & (
                (tmin < t_b) | ((tmin == t_b) & (fid < f_b))
            )
            t_b = jnp.where(better, tmin, t_b)
            f_b = jnp.where(better, fid, f_b)
            u_b = jnp.where(better, umin, u_b)
            v_b = jnp.where(better, vmin, v_b)
            return r + np.int32(1), t_b, f_b, u_b, v_b

        _, t_b, f_b, u_b, v_b = jax.lax.while_loop(
            cond, body, (np.int32(0), t0, f0, u0, u0)
        )
        return t_b.reshape(-1), f_b.reshape(-1), u_b.reshape(-1), v_b.reshape(-1)

    args = tuple(
        a.reshape(n_chunks, chunk)
        for a in (ox, oy, oz, dx, dy, dz, alive_f)
    )
    if n_chunks == 1:
        outs = chunk_fn(tuple(a[0] for a in args))
    else:
        outs = jax.lax.map(chunk_fn, args)
    f_flat = outs[1].reshape(-1)[:flat_n].reshape(shape)
    u_flat = outs[2].reshape(-1)[:flat_n].reshape(shape)
    v_flat = outs[3].reshape(-1)[:flat_n].reshape(shape)
    return f_flat, u_flat, v_flat
