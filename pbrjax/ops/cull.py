"""Cull stage of the curved-patch candidate search: dense candidate selection.

Replaces per-ray BVH *descent* with one vectorized, conservative test of
every ray tile against every cluster AABB (accel/clusters.py). Tiles are
(tile,) runs of the ray batch, each reduced to an interval frustum
(origin AABB x per-axis direction interval), and a cluster is a candidate
for a tile iff the interval slab test cannot rule out an intersection.
Conservative means a candidate list may contain extra clusters (searched
harmlessly by the exact per-ray stage, ops/phongtess.py) but NEVER misses
one that any ray of the tile could hit.

All plain XLA (or NumPy — backend-generic), differentiation-free (the
nearest-face search is detached by contract, ops/traverse.py).
"""

from __future__ import annotations

import numpy as np

from pbrjax.ops.vec import Vec3
from pbrjax.scene.types import ClusterSet
from pbrjax.utils.config import EPSILON5

F32 = np.float32
_BIG = F32(3.0e38)  # finite stand-in for +/-inf (keeps 0*inf NaNs out)


def _tile_minmax(xp, a, tile: int):
    a2 = a.reshape(-1, tile)
    return xp.min(a2, axis=1), xp.max(a2, axis=1)


def frustum_hits(
    xp, o_lo, o_hi, d_lo, d_hi, bb_min: Vec3, bb_max: Vec3, t_cap=None
):
    """Conservative tile-frustum vs cluster-AABB test.

    ``o_lo``/``o_hi``/``d_lo``/``d_hi``: Vec3 of (T,) per-tile component
    bounds. ``bb_min``/``bb_max``: Vec3 of (C,). Returns (T, C) bool.

    Per axis, the slab-crossing parameter t = (slab - o) / d is bounded by
    interval arithmetic: with sign-pure direction intervals the eight
    products of {slab_lo - o_hi, slab_lo - o_lo, slab_hi - o_hi,
    slab_hi - o_lo} x {1/d_lo, 1/d_hi} bound every ray's [t_lo, t_hi];
    a direction interval spanning 0 gives that axis no constraint
    (conservative). A frustum hits iff max-entry <= min-exit and the exit
    is in front (the same gate as the per-ray slab test,
    ops/intersect.py::slab_box). ``t_cap`` (T,): optional conservative
    upper bound on useful t (e.g. max shadow-ray length per tile).

    The entry bound additionally takes the Euclidean box-to-box distance —
    valid for UNIT ray directions (every integrator ray is normalized) and
    independent of the direction interval entirely, so tiles with mixed
    direction signs still get a useful near-to-far ordering and early-out
    key.
    """
    t_entry = xp.full((o_lo.x.shape[0], bb_min.x.shape[0]), -_BIG, dtype=xp.float32)
    t_exit = xp.full_like(t_entry, _BIG)

    for ol, oh, dl, dh, sl, sh in (
        (o_lo.x, o_hi.x, d_lo.x, d_hi.x, bb_min.x, bb_max.x),
        (o_lo.y, o_hi.y, d_lo.y, d_hi.y, bb_min.y, bb_max.y),
        (o_lo.z, o_hi.z, d_lo.z, d_hi.z, bb_min.z, bb_max.z),
    ):
        pure = (dl > 0.0) | (dh < 0.0)  # (T,)
        # Guarded reciprocals (value unused when not pure).
        safe = lambda v: xp.where(pure, v, F32(1.0))  # noqa: E731
        inv_a = (1.0 / safe(dl))[:, None]
        inv_b = (1.0 / safe(dh))[:, None]
        e_ll = sl[None, :] - oh[:, None]  # slab lo minus origin hi, etc.
        e_lh = sl[None, :] - ol[:, None]
        e_hl = sh[None, :] - oh[:, None]
        e_hh = sh[None, :] - ol[:, None]
        p = [
            e_ll * inv_a, e_ll * inv_b, e_lh * inv_a, e_lh * inv_b,
            e_hl * inv_a, e_hl * inv_b, e_hh * inv_a, e_hh * inv_b,
        ]
        t_lo = p[0]
        t_hi = p[0]
        for v in p[1:]:
            t_lo = xp.minimum(t_lo, v)
            t_hi = xp.maximum(t_hi, v)
        pure_c = pure[:, None]
        t_entry = xp.maximum(t_entry, xp.where(pure_c, t_lo, -_BIG))
        t_exit = xp.minimum(t_exit, xp.where(pure_c, t_hi, _BIG))

    # Box-to-box distance lower bound (unit directions): per-axis gap.
    d2 = xp.zeros_like(t_entry)
    for ol, oh, sl, sh in (
        (o_lo.x, o_hi.x, bb_min.x, bb_max.x),
        (o_lo.y, o_hi.y, bb_min.y, bb_max.y),
        (o_lo.z, o_hi.z, bb_min.z, bb_max.z),
    ):
        gap = xp.maximum(
            xp.maximum(sl[None, :] - oh[:, None], ol[:, None] - sh[None, :]),
            F32(0.0),
        )
        # Clamp before squaring: empty octant groups carry +/-BIG bounds
        # whose squared gaps overflow f32 (harmless but noisy); clamping
        # DOWN only lowers the entry bound, which stays conservative.
        gap = xp.minimum(gap, F32(1.0e18))
        d2 = d2 + gap * gap
    dist = xp.sqrt(d2)
    t_entry = xp.maximum(t_entry, dist)

    hit = (t_entry <= t_exit) & (t_exit > F32(EPSILON5))
    if t_cap is not None:
        hit = hit & (t_entry <= t_cap[:, None])
    # Inverted (empty) cluster AABBs never hit; with sign-pure directions
    # the interval test already rejects them, but an all-axes-unconstrained
    # tile would pass, so gate explicitly.
    nonempty = (bb_min.x <= bb_max.x)[None, :]
    # t_entry doubles as the search's early-out key: a lower bound on any
    # tile ray's entry into the cluster (clamped up to 0 — entries behind
    # the origin can still produce forward hits, but never closer than 0).
    return hit & nonempty, xp.maximum(t_entry, F32(0.0))


def candidates_fine(xp, o: Vec3, d: Vec3, cset: ClusterSet, tile: int, t_cap=None):
    """Per-tile candidate cluster lists, near to far.

    ``o``/``d``: flat (N,) ray components, N a multiple of ``tile``.
    Returns ``(cand, counts, tent)``:

    - ``cand`` (T, C) int32 — cluster ids ordered by entry bound, padding
      slots repeating the last valid entry;
    - ``counts`` (T,) int32 — valid entries per tile (0 = tile hits
      nothing);
    - ``tent`` (T, C) f32 — each slot's conservative entry lower bound
      (+BIG on padding slots): a tile is done once every ray's best hit is
      closer than the next slot's ``tent``.
    """
    c = cset.bb_min.x.shape[0]
    ox = _tile_minmax(xp, o.x, tile)
    oy = _tile_minmax(xp, o.y, tile)
    oz = _tile_minmax(xp, o.z, tile)
    dx = _tile_minmax(xp, d.x, tile)
    dy = _tile_minmax(xp, d.y, tile)
    dz = _tile_minmax(xp, d.z, tile)
    o_lo, o_hi = Vec3(ox[0], oy[0], oz[0]), Vec3(ox[1], oy[1], oz[1])
    d_lo, d_hi = Vec3(dx[0], dy[0], dz[0]), Vec3(dx[1], dy[1], dz[1])
    hit, t_entry = frustum_hits(
        xp, o_lo, o_hi, d_lo, d_hi, cset.bb_min, cset.bb_max, t_cap
    )
    counts = xp.sum(hit.astype(xp.int32), axis=1)
    key = xp.where(hit, t_entry, _BIG)
    order = xp.argsort(key, axis=1).astype(xp.int32)
    j = xp.arange(c, dtype=xp.int32)[None, :]
    take = xp.minimum(j, xp.maximum(counts[:, None] - 1, 0))
    cand = xp.take_along_axis(order, take, axis=1)
    tent = xp.where(
        j < counts[:, None], xp.take_along_axis(t_entry, cand, axis=1), _BIG
    )
    return cand, counts, tent
