"""Scene intersection: brute-force sweep and stackless BVH traversal.

The reference's per-ray stackless BVH walk (pt_bvh.cl:82-123) becomes a
*vectorized* walk here: every ray in the batch carries its own node index;
each step gathers one node per ray, does the slab test, and selects the next
index ("hit ⇒ index+1, miss ⇒ escape") — the exact encoding the reference
linearized on the host (BVH.cpp:671-729). The loop runs until every ray has
walked off the end of the node array.

Intersectors with one contract — ``(t, face_idx)`` nearest hit:

- ``intersect_brute``: tests *all* triangles. No gathers, no divergence —
  pure fused elementwise math; it wins for small scenes (a Cornell box is
  34 triangles). ``ops/pallas_intersect.py`` is the same sweep as one
  fused GPU kernel.
- ``intersect_bvh``: the vectorized stackless walk, for large scenes.

Both use identical Möller-Trumbore math and first-wins tie-breaking, so they
are interchangeable (tested against each other), mirroring how the reference
could swap acceleration structures (ACCEL_STRUCT, Cfg ``accel_struct``).
"""

from __future__ import annotations

import numpy as np

from pbrjax.ops.intersect import INF, gather_vec3, moller_trumbore, slab_box
from pbrjax.ops.vec import Vec3
from pbrjax.scene.types import LinearBVH, TrianglesSoA
from pbrjax.utils.config import EPSILON5


def _is_jax(xp) -> bool:
    return xp.__name__.startswith("jax")


def intersect_brute(xp, o: Vec3, d: Vec3, tris: TrianglesSoA):
    """Nearest-hit over all triangles.

    Rays are (B,); triangles (F,). Returns ``(t, face)`` with t = +inf and
    face = -1 on miss. First face in memory order wins ties (strict-<
    update, matching the reference's intersectFace update rule,
    pt_bvh.cl:17-21).
    """
    if _is_jax(xp):
        import jax

        nf = int(tris.mtl.shape[0])
        # full_like keeps shard_map varying-axes metadata attached to o.x
        # (a plain xp.full constant would mismatch the loop carry's vma).
        t0 = xp.full_like(o.x, INF)
        f0 = xp.full_like(o.x, -1, dtype=xp.int32)

        def body(f, state):
            t_best, face_best = state
            v0 = gather_vec3(tris.v0, f)
            e1 = gather_vec3(tris.e1, f)
            e2 = gather_vec3(tris.e2, f)
            t, valid = moller_trumbore(xp, o, d, v0, e1, e2)
            better = valid & (t < t_best)
            return (
                xp.where(better, t, t_best),
                xp.where(better, f.astype(xp.int32), face_best),
            )

        return jax.lax.fori_loop(0, nf, body, (t0, f0))

    return intersect_brute_dense(np, o, d, tris)


def intersect_brute_dense(xp, o: Vec3, d: Vec3, tris: TrianglesSoA):
    """``intersect_brute`` as one broadcast (B, F) Möller-Trumbore and a
    min-reduction over faces. Identical math and tie-breaking (argmin
    picks the first minimal face)."""
    with np.errstate(all="ignore"):
        ob = Vec3(o.x[..., None], o.y[..., None], o.z[..., None])
        db = Vec3(d.x[..., None], d.y[..., None], d.z[..., None])
        v0 = Vec3(tris.v0.x[None, :], tris.v0.y[None, :], tris.v0.z[None, :])
        e1 = Vec3(tris.e1.x[None, :], tris.e1.y[None, :], tris.e1.z[None, :])
        e2 = Vec3(tris.e2.x[None, :], tris.e2.y[None, :], tris.e2.z[None, :])
        t, valid = moller_trumbore(xp, ob, db, v0, e1, e2)
        t = xp.where(valid, t, INF).astype(xp.float32)
        face = xp.argmin(t, axis=-1).astype(xp.int32)
        t_best = xp.min(t, axis=-1)
        face = xp.where(t_best < INF, face, np.int32(-1))
        return t_best, face


def _bvh_step(xp, o, d, inv_d, bvh: LinearBVH, tris: TrianglesSoA, max_leaf, state):
    """One synchronized traversal step for the whole ray batch.

    Matches the reference loop body (pt_bvh.cl:88-122): box test with the
    gates ``t_far > EPSILON5`` and ``t_best > t_near``; on hit of a leaf,
    test its faces; next index = hit ? i+1 : exit[i].
    """
    idx, t_best, face_best, tests, visits = state
    n = bvh.count
    walking = idx < n
    safe = xp.minimum(idx, n - 1)

    bb_min = gather_vec3(bvh.bb_min, safe)
    bb_max = gather_vec3(bvh.bb_max, safe)
    leaf_first = bvh.leaf_first[safe]
    leaf_count = bvh.leaf_count[safe]
    exit_i = bvh.exit[safe]

    t_near, t_far, hit_box = slab_box(xp, o, inv_d, bb_min, bb_max)
    hit_box = hit_box & (t_far > np.float32(EPSILON5)) & (t_best > t_near)

    is_leaf = leaf_first >= 0
    do_leaf = hit_box & is_leaf
    nf = int(tris.mtl.shape[0])
    for k in range(max_leaf):
        fidx = xp.minimum(leaf_first + k, nf - 1)
        v0 = gather_vec3(tris.v0, fidx)
        e1 = gather_vec3(tris.e1, fidx)
        e2 = gather_vec3(tris.e2, fidx)
        t, valid = moller_trumbore(xp, o, d, v0, e1, e2)
        better = do_leaf & (k < leaf_count) & valid & (t < t_best)
        t_best = xp.where(better, t, t_best)
        face_best = xp.where(better, fidx.astype(xp.int32), face_best)

    visits = visits + walking.astype(xp.int32)
    tests = tests + xp.where(
        walking & do_leaf, xp.minimum(leaf_count, max_leaf), np.int32(0)
    )
    nxt = xp.where(hit_box, safe + 1, exit_i)
    idx = xp.where(idx >= n, n, nxt).astype(xp.int32)
    return idx, t_best, face_best, tests, visits


def intersect_bvh(xp, o: Vec3, d: Vec3, bvh: LinearBVH, tris: TrianglesSoA,
                  max_leaf: int = 2, with_counts: bool = False):
    """Nearest-hit via the stackless linear BVH. Same contract as
    ``intersect_brute``. ``max_leaf`` must be a static bound ≥ the builder's
    ``max_faces`` (the reference's compile-time 2-face leaf assumption,
    pt_bvh.cl:35-46, generalized).

    ``with_counts``: additionally return exact per-ray ``(tests, visits)``
    int32 counters — ray-face intersection tests and BVH nodes visited,
    the reference's two per-ray debug counters (pt_bvh.cl:23 increments
    per leaf-face test, :89 per node step)."""
    n = bvh.count
    inv_d = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    idx0 = xp.full_like(o.x, 0, dtype=xp.int32)
    t0 = xp.full_like(o.x, INF)
    f0 = xp.full_like(o.x, -1, dtype=xp.int32)
    c0 = xp.zeros_like(idx0)
    v0_cnt = xp.zeros_like(idx0)

    if _is_jax(xp):
        import jax

        # Pack node and triangle records so each traversal step issues two
        # coherent row-gathers instead of ~15 scalar-array gathers — the
        # per-step cost is gather-bound, and XLA turns an (N, 8)-row gather
        # into one contiguous 32-byte load per ray. Packing is traced once
        # per jit and hoisted out of the frame/scan loops.
        nodes = xp.concatenate(
            [
                xp.stack(
                    [bvh.bb_min.x, bvh.bb_min.y, bvh.bb_min.z,
                     bvh.bb_max.x, bvh.bb_max.y, bvh.bb_max.z],
                    axis=1,
                ),
                xp.stack(
                    [
                        bvh.leaf_first.astype(xp.float32),
                        bvh.leaf_count.astype(xp.float32),
                        bvh.exit.astype(xp.float32),
                    ],
                    axis=1,
                ),
            ],
            axis=1,
        )  # (N, 9): bbmin, bbmax, leaf_first, leaf_count, exit (as f32)
        trisrow = xp.stack(
            [
                tris.v0.x, tris.v0.y, tris.v0.z,
                tris.e1.x, tris.e1.y, tris.e1.z,
                tris.e2.x, tris.e2.y, tris.e2.z,
            ],
            axis=1,
        )  # (F, 9)
        nf = int(tris.mtl.shape[0])

        def body(state):
            idx, t_best, face_best, tests, visits = state
            walking = idx < n
            safe = xp.minimum(idx, n - 1)
            rec = nodes[safe]  # (B, 9) one coherent gather
            bb_min = Vec3(rec[..., 0], rec[..., 1], rec[..., 2])
            bb_max = Vec3(rec[..., 3], rec[..., 4], rec[..., 5])
            leaf_first = rec[..., 6].astype(xp.int32)
            leaf_count = rec[..., 7].astype(xp.int32)
            exit_i = rec[..., 8].astype(xp.int32)

            t_near, t_far, hit_box = slab_box(xp, o, inv_d, bb_min, bb_max)
            hit_box = hit_box & (t_far > np.float32(EPSILON5)) & (t_best > t_near)

            do_leaf = hit_box & (leaf_first >= 0)
            for k in range(max_leaf):
                fidx = xp.clip(leaf_first + k, 0, nf - 1)
                tri = trisrow[fidx]  # (B, 9) one coherent gather
                v0 = Vec3(tri[..., 0], tri[..., 1], tri[..., 2])
                e1 = Vec3(tri[..., 3], tri[..., 4], tri[..., 5])
                e2 = Vec3(tri[..., 6], tri[..., 7], tri[..., 8])
                t, valid = moller_trumbore(xp, o, d, v0, e1, e2)
                better = do_leaf & (k < leaf_count) & valid & (t < t_best)
                t_best = xp.where(better, t, t_best)
                face_best = xp.where(better, fidx.astype(xp.int32), face_best)

            if with_counts:
                # Exact counters, gated on still-walking lanes (a finished
                # lane clamps to node n-1 and must not keep counting while
                # others walk): a node visit per step (pt_bvh.cl:89), a
                # test per REAL leaf face (the walk executes max_leaf
                # lockstep MT evals, but only leaf_count are demanded —
                # pt_bvh.cl:23 semantics).
                visits = visits + walking.astype(xp.int32)
                tests = tests + xp.where(
                    walking & do_leaf,
                    xp.minimum(leaf_count, max_leaf),
                    np.int32(0),
                )

            nxt = xp.where(hit_box, safe + 1, exit_i)
            idx = xp.where(idx >= n, n, nxt).astype(xp.int32)
            return idx, t_best, face_best, tests, visits

        def cond(state):
            return xp.any(state[0] < n)

        idx, t_best, face_best, tests, visits = jax.lax.while_loop(
            cond, body, (idx0, t0, f0, c0, v0_cnt)
        )
        if with_counts:
            return t_best, face_best, tests, visits
        return t_best, face_best

    state = (idx0, t0, f0, c0, v0_cnt)
    with np.errstate(all="ignore"):
        while np.any(state[0] < n):
            state = _bvh_step(np, o, d, inv_d, bvh, tris, max_leaf, state)
    if with_counts:
        return state[1], state[2], state[3], state[4]
    return state[1], state[2]


def _stop_grad3(xp, v: Vec3) -> Vec3:
    if _is_jax(xp):
        import jax

        return Vec3(
            jax.lax.stop_gradient(v.x),
            jax.lax.stop_gradient(v.y),
            jax.lax.stop_gradient(v.z),
        )
    return v


# Largest face count for which the fused brute kernel (ops/pallas_intersect)
# runs instead of the XLA BVH walk on the GPU. Measured on H100s
# (tools/measure_intersect.py crossover; nearest hit + NEE occlusion of 1M
# rays, PERF.md, PR 1): the kernel is faster on bounce rays at every size
# up to 65,536 faces (there 318 vs 400 ms at 700 W with 8-face leaves, 350
# vs 532 ms at 400 W with 16-face leaves) and within 15% either way on
# camera rays; at 100,000 faces the walk ties on bounce rays (485 vs 502
# ms) and wins camera rays (294 vs 488 ms). The kernel's cost is linear in
# F (~4.9 ms per 1k faces), the walk's is not.
GPU_BRUTE_MAX_FACES = 65_536

# Intersector modes ``intersect_scene`` accepts; 'auto' asks
# ``select_intersector``.
MODES = ("auto", "brute", "bvh", "pallas")


def select_intersector(platform: str, num_faces: int, has_bvh: bool) -> str:
    """The intersector 'auto' runs on ``platform`` (a JAX platform name).

    - 'gpu': the fused brute kernel up to ``GPU_BRUTE_MAX_FACES`` faces
      (and for any scene built without a BVH), the XLA BVH walk above;
    - 'cpu': the plain ``intersect_bvh``/``intersect_brute`` (the parity
      paths the tests and the NumPy oracle share);
    - anything else: ValueError.
    """
    if platform == "gpu":
        if has_bvh and num_faces > GPU_BRUTE_MAX_FACES:
            return "bvh"
        return "pallas"
    if platform == "cpu":
        return "bvh" if has_bvh else "brute"
    raise ValueError(f"no intersector for platform {platform!r}")


def trace_platform(xp) -> str:
    """The platform the current trace runs on: 'cpu' for NumPy; for jax,
    the platform of ``jax.default_device`` when one is set (it is part of
    jit's cache key), else the default backend."""
    if not _is_jax(xp):
        return "cpu"
    import jax

    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def intersect_scene(
    xp, o: Vec3, d: Vec3, scene, max_leaf: int = 2, mode: str = "auto",
    light_pos=None, alive=None, with_counts: bool = False,
):
    """Nearest-hit dispatch (the analog of the reference's ACCEL_STRUCT
    kernel specialization, pathtracing.cl:217-219).

    ``mode``: 'auto' (``select_intersector`` for the trace's platform),
    'brute' (XLA ``fori_loop`` sweep), 'bvh' (XLA stackless BVH walk over
    the whole batch) or 'pallas' (the fused brute kernel, GPU only). Any other mode raises
    ValueError.

    Differentiability contract (shared by every mode): the *search* for the
    nearest face runs detached — visibility is non-differentiable by
    convention (and the BVH while_loop has no reverse mode) — then the
    winning face's ``t`` is re-evaluated with one differentiable
    Möller-Trumbore, through which gradients w.r.t. ray origin/direction
    and geometry flow exactly. This also keeps the *backward* pass cheap:
    it never replays the all-faces competition, only the single re-eval.
    Both backends re-evaluate identically so numpy/jax parity holds.

    ``light_pos`` (scalar Vec3, light 0): request the NEE shadow any-hit
    fused into the same device pass. Returns ``(t, face, occluded)`` where
    ``occluded`` is None when the selected mode has no fused path (the
    caller falls back to a separate shadow intersect).

    ``alive``: optional per-ray liveness mask. The fused kernel reports
    dead lanes as misses and skips ray blocks with no live lane; other
    modes ignore it.

    ``with_counts``: additionally return ``(tests, visits)`` as the LAST
    tuple element — per-ray int32 counters matching the reference's two
    debug channels (pt_bvh.cl:23 intersection tests, :89 node visits).
    Both are exact: per-leaf demanded counts and node steps on the BVH
    walk; the full-sweep constant (F, or 2F with the fused NEE leg) and
    None for visits on the sweeps (no nodes exist to visit).
    """
    if mode not in MODES:
        raise ValueError(f"unknown intersector mode {mode!r}; expected one of {MODES}")
    o_s = _stop_grad3(xp, o)
    d_s = _stop_grad3(xp, d)
    occ = None
    counts = None
    visits = None
    if mode == "auto":
        mode = select_intersector(
            trace_platform(xp), scene.tris.count, scene.bvh is not None
        )
    if mode == "bvh":
        out = intersect_bvh(xp, o_s, d_s, scene.bvh, scene.tris,
                            max_leaf=max_leaf, with_counts=with_counts)
        if with_counts:
            _, face, counts, visits = out
        else:
            _, face = out
    elif mode == "pallas":
        from pbrjax.ops.pallas_intersect import intersect_pallas

        if not _is_jax(xp):
            raise ValueError("mode 'pallas' needs the jax backend")
        out = intersect_pallas(
            xp, o_s, d_s, scene.tris, light_pos=light_pos, alive=alive
        )
        if light_pos is not None:
            _, face, occ = out
        else:
            _, face = out
    else:
        _, face = intersect_brute(xp, o_s, d_s, scene.tris)

    # Differentiable re-evaluation of the winner. Geometry is detached
    # (gradient targets are materials/lights/camera — BASELINE.json; a
    # gather's transpose is a giant scatter-add, so detaching the triangle
    # arrays also keeps the backward pass cheap); o and d stay live, which
    # is where camera gradients flow.
    safe = xp.maximum(face, 0)
    tris_s = scene.tris
    if _is_jax(xp):
        import jax

        tris_s = jax.tree_util.tree_map(jax.lax.stop_gradient, tris_s)
    v0 = gather_vec3(tris_s.v0, safe)
    e1 = gather_vec3(tris_s.e1, safe)
    e2 = gather_vec3(tris_s.e2, safe)
    t_re, _ = moller_trumbore(xp, o, d, v0, e1, e2)
    t = xp.where(face >= 0, t_re, INF)
    if with_counts and counts is None:
        # Full-sweep intersectors test every face; the fused NEE leg
        # sweeps them again for the shadow ray.
        nf = np.int32(scene.tris.count * (2 if occ is not None else 1))
        counts = xp.full_like(face, nf)
    out = [t, face]
    if light_pos is not None:
        out.append(occ)  # occ is None unless a fused mode produced it
    if with_counts:
        out.append((counts, visits))
    return tuple(out)
