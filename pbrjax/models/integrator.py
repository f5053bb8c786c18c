"""The wavefront path-tracing integrator.

This is the wavefront re-design of the reference's per-pixel megakernel
(``pathtracing.cl:207-334``): instead of one divergent work-item per pixel,
the whole ray batch advances together through fixed-shape stages —
*generate* (camera rays + AA jitter + thin-lens DoF), *intersect* (brute or
stackless-BVH), *shade* (NEE, BRDF sample, throughput update, Russian
roulette) — with per-ray liveness as masks. Every dynamic control decision
of the reference (miss/break/extend/RR) becomes a ``where``; the bounce loop
is a statically-bounded Python loop (MAX_DEPTH + MAX_ADDED_DEPTH, the same
bound the reference's dynamic loop respects, pathtracing.cl:258,308), so XLA
unrolls and fuses the whole integrator into a handful of device kernels.

The function is backend-generic: pass ``xp = numpy`` and it is the CPU
oracle tracer (bit-identical math and RNG); pass ``xp = jax.numpy`` inside
``jit`` and it is the device renderer. Gradients w.r.t. materials, lights, and
camera flow through shading with detached sampling (sample directions are
RNG-hash constants; the importance-sampling pdf stays in the weight).

Estimator semantics faithfully match the reference, including its quirks:
``secondaryPaths`` starts at 1 and is shared across samples of a frame
(pathtracing.cl:249,326); orb lights are only visible on geometry-miss
(pt_bvh.cl:54-74); the last-bounce opportunistic break skips NEE
(pathtracing.cl:274-276); NEE always samples ``lights[0]``
(pathtracing.cl:188-199).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import numpy as np

from pbrjax.ops import rng as rng_mod
from pbrjax.ops.brdf import (
    PI_X2,
    fresnel,
    refract_dir,
    sa_eval,
    sa_sample,
    schlick_eval,
    schlick_sample,
)
from pbrjax.ops.intersect import INF, gather_vec3, geometric_normal, sphere
from pbrjax.ops.rng import (
    S_AA_PHI,
    S_AA_R,
    S_BRDF_A,
    S_BRDF_B,
    S_BRDF_C,
    S_DOF_PHI,
    S_DOF_R,
    S_EXTEND,
    S_REFR,
    S_RR,
    S_TRANS,
)
from pbrjax.ops.traverse import intersect_scene
from pbrjax.ops.vec import Vec3, jitter, safe_div, safe_sqrt, where3
from pbrjax.scene.camera import pixel_dim
from pbrjax.scene.types import CameraState, Scene
from pbrjax.utils.config import BRDF_SCHLICK, RenderSettings

F32 = np.float32


class TraceResult(NamedTuple):
    color: Vec3  # (B,) accumulated frame color (pre-progressive-mix)
    focus_t: object  # (B,) first-hit distance (DoF focus channel, pt_rgb.cl:18)
    # Optional diagnostics (None unless requested):
    n_path_rays: object = None  # () total path segments traced (live lanes)
    n_shadow_rays: object = None  # () total NEE shadow rays traced
    heat_bounces: object = None  # (B,) per-pixel live-bounce count (debug heatmap)
    n_dropped: object = None  # () lanes terminated by compaction-capacity overflow
    bounce_row_live: object = None  # (max_total_depth,) live-ROW fraction at
    # the start of each bounce (at compact_block granularity, normalized by
    # the full-width row count) — the occupancy signal the auto compaction
    # schedule derives caps from (models/pathtracer.py::probe_compact_schedule)
    heat_tests: object = None  # (B,) per-pixel ray-face intersection tests
    # (the reference's debug counter, pt_bvh.cl:23 -> pathtracing.cl:73-78)
    heat_visits: object = None  # (B,) per-pixel BVH node visits (the
    # reference's second debug counter, pt_bvh.cl:89); exact on the tree
    # walks, all-zero under intersectors that visit no nodes (the brute
    # sweeps are traversal-free by design)


def _where(xp, m, a, b):
    return xp.where(m, a, b)


def _sanitize3(xp, v: Vec3) -> Vec3:
    """Replace non-finite components with 0.

    Deliberate deviation from the reference: when a sampled direction makes
    the pdf collapse to 0 (e.g. the S-A half-vector dips below the horizon,
    pow(h·n, e) → 0, pt_brdf.cl:252-267), the reference divides 0/0 and
    writes NaN pixels (the thesis CHANGELOG notes such artifacts). We define
    the weight of an impossible sample as 0 — identically in the NumPy
    oracle and the jax path, so the allclose gate is unaffected.
    """
    f = lambda c: xp.where(xp.isfinite(c), c, np.float32(0.0))  # noqa: E731
    return Vec3(f(v.x), f(v.y), f(v.z))


@functools.lru_cache(maxsize=None)
def _select_gather_vjp(m: int):
    """custom_vjp'd select-chain material gather for M = ``m`` materials.

    Forward: the broadcast select chain (fuses into the shade fusion,
    exact table values). Backward: ONE thin matmul
    ``cotangents (14, B) @ one-hot (B, M)`` instead of AD's 14
    per-material masked sum-reduce chains. Numerics: the matmul computes
    the same masked sums (HIGHEST precision, so no TF32; reduction order
    differs at ULP level only). Opt-in (``PBRJAX_GATHER_VJP=1``); not
    measured on the GPU.
    """
    import jax
    import jax.numpy as jnp

    @jax.custom_vjp
    def gather(fields, midx):
        ones = jnp.ones_like(midx, dtype=jnp.float32)
        sels = [midx == np.int32(i) for i in range(1, m)]
        outs = []
        for f in fields:
            v = f[0] * ones
            for i, sel in enumerate(sels):
                v = jnp.where(sel, f[i + 1], v)
            outs.append(v)
        return tuple(outs)

    def fwd(fields, midx):
        return gather(fields, midx), midx

    def bwd(midx, cts):
        onehot = (
            midx[:, None] == jnp.arange(m, dtype=midx.dtype)[None, :]
        ).astype(jnp.float32)
        C = jnp.stack(cts, axis=0)  # (14, B)
        G = jax.lax.dot_general(
            C, onehot, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )  # (14, M)
        return (
            tuple(G[i] for i in range(14)),
            np.zeros(midx.shape, dtype=jax.dtypes.float0),
        )

    gather.defvjp(fwd, bwd)
    return gather


def _gather_materials(xp, mats, midx):
    """Gather all per-ray material fields.

    On the jax path with few materials each field is a broadcast
    select-chain over the material index: numerically exact (it picks the
    table value verbatim) and it fuses entirely into the surrounding shade
    fusion (no (B, 14) intermediate in device memory); AD's backward is a
    masked sum-reduce per material (``_select_gather_vjp`` is the opt-in
    matmul backward). Mid-size M keeps the one-hot matmul (select chains
    grow linearly); NumPy and large-M fall back to fancy indexing.
    """
    fields = (
        mats.d, mats.Ni, mats.rough, mats.p, mats.nu, mats.nv, mats.Rs, mats.Rd,
        mats.kd.x, mats.kd.y, mats.kd.z, mats.ks.x, mats.ks.y, mats.ks.z,
    )
    m = int(mats.d.shape[0])
    use_vjp = os.environ.get("PBRJAX_GATHER_VJP", "0") == "1"
    if xp.__name__.startswith("jax") and m <= 16 and use_vjp:
        vals = list(_select_gather_vjp(m)(fields, midx))
    elif xp.__name__.startswith("jax") and m <= 16:
        ones = xp.ones_like(midx, dtype=xp.float32)
        sels = [midx == np.int32(i) for i in range(1, m)]

        def pick(f):
            v = f[0] * ones
            for i, sel in enumerate(sels):
                v = xp.where(sel, f[i + 1], v)
            return v

        vals = [pick(f) for f in fields]
    elif xp.__name__.startswith("jax") and m <= 128:
        import jax

        table = xp.stack(fields, axis=1)  # (M, 14)
        onehot = (midx[:, None] == xp.arange(m, dtype=midx.dtype)[None, :]).astype(
            xp.float32
        )
        out = jax.lax.dot_general(
            onehot, table, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,  # no TF32: exact table picks
            preferred_element_type=xp.float32,
        )  # (B, 14)
        vals = [out[:, i] for i in range(14)]
    else:
        vals = [f[midx] for f in fields]
    return (
        vals[0], vals[1], vals[2], vals[3], vals[4], vals[5], vals[6], vals[7],
        Vec3(vals[8], vals[9], vals[10]), Vec3(vals[11], vals[12], vals[13]),
    )


def _compact_rows(xp, alive, block: int, cap: int):
    """Index plumbing for row-granular live compaction.

    Lanes are grouped into rows of ``block`` consecutive lanes; a row is
    live iff ANY of its lanes is (see RenderSettings.compact_block). Returns ``(src, slot, n_ok, n_drop)`` over
    ROWS:

    - ``src`` (cap,): original row index of the j-th live row (row order
      preserved — a stable partition), 0-filled past the live count;
    - ``slot`` (R,): each original row's compact slot, or ``cap`` when the
      row is dead or overflowed capacity (out-of-range sentinel);
    - ``n_ok`` (): live rows that got a slot;
    - ``n_drop`` (): live LANES terminated because row capacity overflowed.

    One tiny (R,) cumsum + scatter; everything downstream is row gathers.
    """
    r = alive.shape[0] // block
    a2 = alive.reshape(r, block)
    row_live = xp.any(a2, axis=1)
    pos = xp.cumsum(row_live.astype(xp.int32)) - 1
    ok = row_live & (pos < cap)
    slot = xp.where(ok, pos, cap).astype(xp.int32)
    ridx = xp.arange(r, dtype=xp.int32)
    if xp.__name__.startswith("jax"):
        src = xp.zeros((cap,), dtype=xp.int32).at[slot].set(ridx, mode="drop")
    else:
        src = np.zeros((cap,), dtype=np.int32)
        m = np.asarray(ok)
        src[np.asarray(pos)[m]] = ridx[m]
    n_live = xp.sum(row_live.astype(xp.int32))
    n_ok = xp.minimum(n_live, cap)
    n_drop = xp.sum(xp.where(row_live & ~ok, xp.sum(a2.astype(xp.int32), axis=1), 0))
    return src, slot, n_ok, n_drop


def _take_rows(xp, v, src, block: int):
    """Gather rows of ``block`` consecutive lanes: (R*block,) -> (cap*block,)."""
    return v.reshape(-1, block)[src].reshape(-1)


def _run_phase(xp, settings, body, carry, lo: int, hi: int):
    """Run bounces [lo, hi) of ``body`` over ``carry``.

    jax + 'scan': lax.scan over the bounce index (one traced body, ~8x
    faster compiles); otherwise a Python unroll ('unroll' trades compile
    time for ~1.8x faster fwd+bwd via cross-bounce XLA optimization).
    Numerics are identical.
    """
    if lo >= hi:
        return carry
    is_jax = xp.__name__.startswith("jax")
    if is_jax and settings.remat == "save_isect":
        import jax

        body = jax.checkpoint(
            body,
            policy=jax.checkpoint_policies.save_only_these_names("isect"),
        )
    if is_jax and settings.bounce_loop == "scan":
        import jax

        carry, _ = jax.lax.scan(
            lambda c, dep: (body(dep, c), None),
            carry,
            xp.arange(lo, hi, dtype=xp.int32),
        )
    else:
        for dep in range(lo, hi):
            carry = body(np.int32(dep), carry)
    return carry


def _broadcast_cam(cam: CameraState, like):
    """Broadcast scalar camera Vec3s to the ray batch shape."""
    ones = like * 0.0 + 1.0
    b = lambda v: Vec3(v.x * ones, v.y * ones, v.z * ones)  # noqa: E731
    return b(cam.eye), b(cam.w), b(cam.u), b(cam.v)


def _gen_rays(xp, cam: CameraState, settings: RenderSettings, px, py, rng, s, prev_t):
    """Primary ray generation: pinhole + AA jitter + thin-lens DoF
    (initRay, pathtracing.cl:25-48; antiAliasing, pt_utils.cl:327-337;
    depthOfField, pt_utils.cl:349-373)."""
    w, h = settings.width, settings.height
    pxdim = F32(pixel_dim(w, h, settings.fov))
    eye, cw, cu, cv = _broadcast_cam(cam, px)

    fx = 1.0 - F32(w) + 2.0 * px
    fy = 1.0 - F32(h) + 2.0 * py
    d = (cw + (cu * fx + cv * fy) * (pxdim * F32(0.5))).normalized()

    # Anti-aliasing: jitter within the pixel footprint. One bound (s, 0)
    # hash prefix feeds all four primary-ray streams (rng.py PixelRng.at).
    r0 = rng.at(s, 0)
    rnd = r0.u(S_AA_R)
    phi = PI_X2 * r0.u(S_AA_PHI)
    aa = jitter(d, phi, xp.sqrt(rnd), xp.sqrt(1.0 - rnd))
    d = (d + aa * (pxdim * F32(settings.anti_aliasing))).normalized()

    o = eye

    # Thin-lens depth of field, gated on a non-negative focus distance.
    t_obj = _where(xp, xp.isfinite(prev_t), prev_t, F32(1000.0))
    t_foc = _where(xp, xp.isfinite(cam.focus), cam.focus, F32(1000.0))
    lens = cam.focal_length / cam.aperture  # reference cam.lense.x / .y
    radius = r0.u(S_DOF_R) * lens * F32(0.5)
    angle = PI_X2 * r0.u(S_DOF_PHI)
    o_dof = o + cu * (radius * xp.cos(angle)) + cv * (radius * xp.sin(angle))
    hit_focal = eye + d * t_foc
    d_dof = (hit_focal - o_dof).normalized()
    use_dof = (cam.focus >= 0.0) & (t_obj > 0.0)
    o = where3(use_dof, o_dof, o)
    d = where3(use_dof, d_dof, d)
    return o, d


def _orb_pass(xp, o, d, lights, t_geom):
    """Orb-light visibility on geometry miss (traverseLights,
    pt_bvh.cl:54-74): the *last* orb hit in light order wins; any geometry
    hit overrides."""
    nl = lights.count
    orb_idx = xp.full(o.x.shape, -1, dtype=xp.int32)
    for i in range(nl):
        center = Vec3(lights.pos.x[i], lights.pos.y[i], lights.pos.z[i])
        t_near, hit = sphere(xp, o, d, center, lights.radius[i])
        is_orb = lights.type[i] == 2
        orb_idx = _where(xp, is_orb & hit, xp.int32(i), orb_idx)
    miss_geom = ~xp.isfinite(t_geom)
    return _where(xp, miss_geom, orb_idx, xp.int32(-1))


def _shadow_occluded(xp, scene, hit_p, l_dir, t_light, max_leaf, mode, pt_alpha=0.0):
    """Any-hit shadow test (traverseShadows, pt_bvh.cl:133-177): occluded
    iff some *geometry* hit lies closer than the light (orbs never occlude —
    the reference resets t to INF on orb hits, pt_bvh.cl:68). With Phong
    tessellation enabled, shadow rays test the curved patches too, as the
    reference's shared checkFaceIntersection did."""
    if pt_alpha > 0.0:
        from pbrjax.ops.phongtess import intersect_scene_phongtess

        t_sh, _, _, _ = intersect_scene_phongtess(
            xp, hit_p, l_dir, scene, F32(pt_alpha), max_leaf=max_leaf
        )
    else:
        t_sh, _ = intersect_scene(xp, hit_p, l_dir, scene, max_leaf=max_leaf, mode=mode)
    return t_sh < t_light


def trace_rays(
    xp,
    scene: Scene,
    cam: CameraState,
    settings: RenderSettings,
    pixel_ids,
    frame_seed,
    prev_t=None,
    max_leaf: int = 2,
    with_stats: bool = False,
) -> TraceResult:
    """Trace ``settings.samples`` full paths for each pixel id.

    ``pixel_ids``: (B,) int32 global pixel indices (y * width + x) — the
    batch may be any shard of the image, which is what makes the ray-batch
    dimension shardable across chips. ``prev_t``: previous frame's per-pixel
    first-hit distance (for DoF), or None.
    """
    ids = pixel_ids
    px = (ids % settings.width).astype(xp.float32)
    py = (ids // settings.width).astype(xp.float32)
    rng = rng_mod.PixelRng(frame_seed, ids.astype(xp.uint32))

    # Micro-scope rematerialization of the BRDF evals and the material
    # gather: jax.checkpoint at the FUNCTION scope stores only the
    # callee's inputs (already live for other consumers) and recomputes
    # its interior in the backward instead of streaming its intermediates
    # through device memory as residuals. Default ON; the env vars
    # (PBRJAX_CKPT_BRDF / PBRJAX_CKPT_GATHER = 0) switch it off for an A/B,
    # not yet made on the GPU. Gradients are unchanged (identical ops
    # recomputed in identical order).
    brdf_eval_schlick = schlick_eval
    brdf_eval_sa = sa_eval
    gather_materials = _gather_materials
    if xp.__name__.startswith("jax") and os.environ.get("PBRJAX_CKPT_BRDF", "1") == "1":
        import jax

        brdf_eval_schlick = jax.checkpoint(schlick_eval, static_argnums=(0,))
        brdf_eval_sa = jax.checkpoint(sa_eval, static_argnums=(0,))
    if xp.__name__.startswith("jax") and os.environ.get("PBRJAX_CKPT_GATHER", "1") == "1":
        import jax

        gather_materials = jax.checkpoint(_gather_materials, static_argnums=(0,))

    if prev_t is None:
        prev_t = xp.full(px.shape, INF, dtype=xp.float32)

    # All state arrays derive from ``base`` = px + 0*u(seed): numerically
    # identical to px, but it carries the union of the pixel batch's and the
    # seed's shard_map varying-axes metadata, so scan carries typecheck when
    # the seed is a per-shard value (sample-parallel rendering).
    base = px + rng.u(0, 0, S_RR) * F32(0.0)
    zero3 = Vec3(xp.zeros_like(base), xp.zeros_like(base), xp.zeros_like(base))
    final_color = zero3
    secondary = xp.full_like(base, 1, dtype=xp.int32)  # starts at 1 (pathtracing.cl:249)
    focus_t = xp.full_like(base, INF)

    # Work counters — the analog of the reference's per-ray debug counters
    # (intersection tests / node visits → debug image, pt_bvh.cl:23,89).
    n_path = xp.sum(xp.zeros_like(base)).astype(xp.int32) if with_stats else None
    n_shadow = xp.sum(xp.zeros_like(base)).astype(xp.int32) if with_stats else None
    heat = xp.zeros_like(base, dtype=xp.int32) if with_stats else None
    # The heat_tests slot carries a PAIR (tests, visits) through the
    # sample/bounce/compaction plumbing — one pytree slot, two exact
    # reference debug channels (pt_bvh.cl:23 and :89).
    heat_tests = (
        (xp.zeros_like(base, dtype=xp.int32), xp.zeros_like(base, dtype=xp.int32))
        if with_stats
        else None
    )

    mats = scene.materials
    lights = scene.lights
    num_lights = scene.num_lights
    nee_enabled = bool(settings.shadow_rays) and num_lights > 0
    sky = Vec3(F32(settings.sky_light[0]), F32(settings.sky_light[1]), F32(settings.sky_light[2]))

    # Live-path compaction plan (see RenderSettings.compact_schedule): the
    # reference's dynamic loop bound means that past max_depth only
    # *extended* paths (specular/transparent hits) survive — a few percent
    # of the batch — yet fixed shapes make every bounce pay full width.
    # Compacting the surviving ROWS (compact_block consecutive lanes, so
    # every gather moves contiguous runs) into successively smaller
    # buffers keeps the math bitwise
    # identical (pure permutation; RNG is pixel-keyed) while the late
    # bounces run at a fraction of the cost.
    batch = int(np.prod(px.shape)) if px.shape else 1
    block = max(1, int(settings.compact_block))
    while block > 1 and batch % block:
        block //= 2
    rows_total = batch // block
    schedule = []  # validated [(bounce, row capacity)], strictly shrinking
    prev_cap = rows_total
    prev_kb = 0
    # Round capacities up to whole ray blocks of the fused intersect kernel
    # (ops/pallas_intersect.py BLOCK lanes) so the compacted stages need no
    # pad/unpad around every kernel call (the spare rows are dead lanes,
    # and a block of dead lanes skips the kernel's face loop).
    from pbrjax.ops.pallas_intersect import BLOCK

    tile_rows = max(1, BLOCK // block) if BLOCK % block == 0 else 1
    if rows_total % tile_rows:
        tile_rows = 1  # tiny batches (tests) can't align to device tiles
    for kb, frac in sorted(settings.compact_schedule):
        cap = max(1, int(np.ceil(rows_total * frac)))
        cap = min(rows_total, -(-cap // tile_rows) * tile_rows)
        if prev_kb < kb < settings.max_total_depth and 0 < cap < prev_cap:
            schedule.append((kb, cap))
            prev_cap, prev_kb = cap, kb
    # Dropped-lane counter: ALWAYS computed when a compaction schedule is
    # active (not just under with_stats) — capacity overflow silently
    # biases renders (round-3 hit this on suzanne, commit 773e0b4), so the
    # caller must be able to warn without opting into the heavy stats. The
    # count is two tiny reductions per stage, invisible in the profile.
    n_drop_total = (
        xp.sum(xp.zeros_like(base)).astype(xp.int32) if schedule else None
    )
    row_frac = (
        xp.zeros((settings.max_total_depth,), xp.float32) if with_stats else None
    )

    def sample_body(s, sample_state):
        """One full path per pixel (sample ``s`` of the frame).

        ``s`` is a Python int under ``sample_loop='unroll'`` and a traced
        int32 under 'scan' — the RNG is (pixel, sample, bounce)-keyed
        either way, so numerics are identical (the reference's SAMPLES
        loop was likewise one device-side loop, pathtracing.cl:251).
        """
        (
            final_color, secondary, focus_t, n_path, n_shadow, heat,
            heat_tests, row_frac, n_drop_total,
        ) = sample_state
        is_s0 = s == 0  # sample 0 owns the DoF focus channel
        o, d = _gen_rays(xp, cam, settings, px, py, rng, s, prev_t)
        color = Vec3(xp.full_like(base, 1.0), xp.full_like(base, 1.0), xp.full_like(base, 1.0))
        light_found = xp.zeros_like(base, dtype=bool)
        light_val = zero3
        alive = xp.full_like(base, True, dtype=bool)
        depth_added = xp.zeros_like(base, dtype=xp.int32)

        # px/rng/zero3 are explicit parameters (bound with partial) so the
        # same body runs full-width and, after compaction, on the gathered
        # sub-batch — the only difference is which lanes it sees.
        def bounce_body(px, rng, zero3, depth, carry):
            (
                o, d, color, alive, light_found, light_val, depth_added,
                final_color, secondary, focus_t, n_path, n_shadow, heat,
                heat_tests, row_frac,
            ) = carry
            if with_stats:
                n_path = n_path + xp.sum(alive.astype(xp.int32))
                heat = heat + alive.astype(xp.int32)
                # Row occupancy at the production compaction granularity,
                # normalized by the FULL-width row count (stage-invariant).
                rl = xp.any(alive.reshape(-1, block), axis=1)
                frac = xp.sum(rl.astype(xp.float32)) / F32(rows_total)
                row_frac = row_frac + (
                    xp.arange(settings.max_total_depth, dtype=xp.int32) == depth
                ).astype(xp.float32) * frac
            # ---- intersect -------------------------------------------------
            occ_fused = None  # NEE occlusion fused into the intersect kernel
            isect_counts = None  # per-ray test counts (stats heatmap)
            if settings.phong_tessellation > 0.0:
                # Curved patches trace through the BVH when the scene has
                # one (leaf AABBs inflated at build time — scene.build
                # phong_tess_alpha); brute sweep otherwise.
                from pbrjax.ops.phongtess import intersect_scene_phongtess

                t, face, pt_u, pt_v = intersect_scene_phongtess(
                    xp, o, d, scene, F32(settings.phong_tessellation),
                    max_leaf=max_leaf, alive=alive,
                )
            else:
                if nee_enabled:
                    l0 = Vec3(lights.pos.x[0], lights.pos.y[0], lights.pos.z[0])
                    out = intersect_scene(
                        xp, o, d, scene, max_leaf=max_leaf,
                        mode=settings.intersector, light_pos=l0, alive=alive,
                        with_counts=with_stats,
                    )
                    if with_stats:
                        t, face, occ_fused, isect_counts = out
                    else:
                        t, face, occ_fused = out
                else:
                    out = intersect_scene(
                        xp, o, d, scene, max_leaf=max_leaf,
                        mode=settings.intersector, alive=alive,
                        with_counts=with_stats,
                    )
                    if with_stats:
                        t, face, isect_counts = out
                    else:
                        t, face = out
                pt_u = pt_v = None
            if with_stats and isect_counts is not None:
                tst, vst = isect_counts
                ht, hv = heat_tests
                if tst is not None:
                    ht = ht + xp.where(alive, tst, np.int32(0))
                if vst is not None:
                    hv = hv + xp.where(alive, vst, np.int32(0))
                heat_tests = (ht, hv)
            if xp.__name__.startswith("jax") and settings.remat == "save_isect":
                # Mark the intersect outputs as the ONLY residuals worth
                # saving across the forward/backward boundary (see
                # RenderSettings.remat): tiny to store, expensive to recompute.
                from jax.ad_checkpoint import checkpoint_name

                t = checkpoint_name(t, "isect")
                face = checkpoint_name(face, "isect")
                if occ_fused is not None:
                    occ_fused = checkpoint_name(occ_fused, "isect")
            orb_idx = _orb_pass(xp, o, d, lights, t) if num_lights else xp.full(
                px.shape, -1, dtype=xp.int32
            )

            # focus = first-bounce hit distance of sample 0
            # (pathtracing.cl:261).
            focus_t = _where(xp, is_s0 & (depth == 0), t, focus_t)

            hit = xp.isfinite(t) & alive
            # ---- miss: sky or orb emission (pathtracing.cl:263-266) -------
            miss = alive & ~xp.isfinite(t)
            is_orb = miss & (orb_idx >= 0)
            orb_safe = xp.maximum(orb_idx, 0)
            # Per-light scalar broadcast select, NOT a B-lane gather: the
            # gather's transpose is a million-lane scatter-add into the
            # light rgb arrays; the select transposes to masked
            # sum-reduces. L is small (1-2 lights in every reference scene).
            if num_lights:
                ones_b = xp.ones_like(px)
                orb_rgb = zero3
                for li in range(num_lights):
                    sel = orb_safe == li
                    orb_rgb = where3(
                        sel,
                        Vec3(
                            lights.rgb.x[li] * ones_b,
                            lights.rgb.y[li] * ones_b,
                            lights.rgb.z[li] * ones_b,
                        ),
                        orb_rgb,
                    )
            else:
                orb_rgb = zero3
            sky_b = Vec3(sky.x + 0.0 * px, sky.y + 0.0 * px, sky.z + 0.0 * px)
            new_light = where3(is_orb, orb_rgb, sky_b)
            light_val = where3(miss, new_light, light_val)
            light_found = light_found | miss
            alive = alive & ~miss

            # ---- material & geometric normal ------------------------------
            face_safe = xp.maximum(face, 0)
            tris_sg = scene.tris
            if xp.__name__.startswith("jax"):
                import jax

                # Geometry is not a gradient target; detaching it here keeps
                # the backward free of million-lane scatter-adds into the
                # (F,) triangle arrays.
                tris_sg = jax.tree_util.tree_map(jax.lax.stop_gradient, tris_sg)
            midx = tris_sg.mtl[face_safe]
            (
                m_d, m_ni, m_rough, m_p, m_nu, m_nv, m_rs, m_rd, m_kd, m_ks
            ) = gather_materials(xp, mats, midx)
            e1 = gather_vec3(tris_sg.e1, face_safe)
            e2 = gather_vec3(tris_sg.e2, face_safe)
            normal = geometric_normal(e1, e2)
            if pt_u is not None:
                # Curved-patch shading normal for Phong-tessellated winners
                # (getPhongTessNormal, pt_utils.cl:282-294).
                from pbrjax.ops.phongtess import (
                    face_is_flat,
                    patch_constants,
                    phongtess_normal,
                )

                n1g = gather_vec3(tris_sg.n0, face_safe)
                n2g = gather_vec3(tris_sg.n1, face_safe)
                n3g = gather_vec3(tris_sg.n2, face_safe)
                v0g = gather_vec3(tris_sg.v0, face_safe)
                c1, c2, c3, e12, e20 = patch_constants(
                    v0g, v0g + e1, v0g + e2, n1g, n2g, n3g,
                    F32(settings.phong_tessellation),
                )
                n_pt = phongtess_normal(
                    xp, d, n1g, n2g, n3g, c1, c2, c3, e12, e20, pt_u, pt_v
                )
                flat_w = face_is_flat(xp, tris_sg)[face_safe]
                normal = where3(flat_w, normal, n_pt)

            # ---- path extension decision (extendDepth, pt_utils.cl:89-96) -
            # One bound (s, depth) hash prefix feeds the bounce's 7 streams.
            rb = rng.at(s, depth)
            if settings.brdf == BRDF_SCHLICK:
                extend = m_rough < rb.u(S_EXTEND)
            else:
                extend = xp.maximum(m_nu, m_nv) >= 50.0

            # ---- opportunistic last-bounce break (pathtracing.cl:274-276) -
            is_last = depth == (settings.max_depth + depth_added - 1)
            brk = hit & (m_d == 1.0) & ~extend & is_last
            alive = alive & ~brk
            live = hit & alive  # rays shaded this bounce

            # ---- hit point (guarded for dead lanes) ------------------------
            t_safe = _where(xp, hit, t, F32(1.0))
            hit_p = o + d * t_safe

            # ---- NEE shadow ray (shadowRayTest, pathtracing.cl:188-199) ---
            if nee_enabled:
                l_pos = Vec3(
                    lights.pos.x[0] + 0.0 * px,
                    lights.pos.y[0] + 0.0 * px,
                    lights.pos.z[0] + 0.0 * px,
                )
                l_vec = l_pos - hit_p
                t_light = safe_sqrt(l_vec.length2())
                l_dir = l_vec * safe_div(F32(1.0), t_light)
                if occ_fused is not None:
                    occluded = occ_fused
                else:
                    occluded = _shadow_occluded(
                        xp, scene, hit_p, l_dir, t_light, max_leaf,
                        settings.intersector, settings.phong_tessellation,
                    )
                nee_ok = live & (m_d > 0.0) & ~occluded
                if with_stats:
                    n_shadow = n_shadow + xp.sum((live & (m_d > 0.0)).astype(xp.int32))
            else:
                l_dir = zero3
                nee_ok = xp.zeros(px.shape, dtype=bool)

            # ---- new direction (getNewRay, pt_brdf.cl:344-378) ------------
            if settings.no_transparency:
                # Static specialization: every material is opaque, so the
                # transmit branch is identically dead — skip the Fresnel/
                # TIR refraction chain and its two RNG draws entirely
                # (bitwise-identical: streams are independently keyed).
                do_trans = xp.zeros(px.shape, dtype=bool)
                add_depth = extend
            else:
                r_trans = rb.u(S_TRANS)
                do_trans = (m_d < 1.0) & (m_d <= r_trans)
                add_depth = extend | do_trans
                refr = refract_dir(xp, d, normal, m_ni, rb.u(S_REFR))
            ra = rb.u(S_BRDF_A)
            rbb = rb.u(S_BRDF_B)
            rc = rb.u(S_BRDF_C)
            if settings.brdf == BRDF_SCHLICK:
                brdf_dir = schlick_sample(xp, d, normal, m_rough, m_p, ra, rbb, rc)
            else:
                brdf_dir = sa_sample(xp, d, normal, m_d, m_nu, m_nv, ra, rbb, rc)
            new_d = (
                brdf_dir
                if settings.no_transparency
                else where3(do_trans, refr, brdf_dir)
            )
            # Detached sampling: sample *positions* carry no gradient (the
            # importance-sampling pdf in the weight does); cutting the
            # sampler chains (arccos/tan/jitter x bounces) out of the
            # backward pass is also a large fwd+bwd speedup.
            if xp.__name__.startswith("jax"):
                import jax

                new_d = Vec3(
                    jax.lax.stop_gradient(new_d.x),
                    jax.lax.stop_gradient(new_d.y),
                    jax.lax.stop_gradient(new_d.z),
                )

            # ---- flip normal toward the viewer (pathtracing.cl:296-300) ---
            n_sh = where3(normal.dot(-d) <= 0.0, -normal, normal)

            # ---- throughput & NEE contribution (updateColor,
            #      pathtracing.cl:92-178) ----------------------------------
            if settings.brdf == BRDF_SCHLICK:
                if nee_enabled:
                    brdf_l, u_l, pdf_l = brdf_eval_schlick(xp, n_sh, d, l_dir, m_rough, m_p)
                    ok = nee_ok & (xp.abs(pdf_l) > F32(1e-5))
                    pdf_ls = _where(xp, ok, pdf_l, F32(1.0))
                    w_l = brdf_l * xp.maximum(n_sh.dot(l_dir), 0.0) / pdf_ls
                    # Scalar index + broadcast (NOT a B-lane gather of
                    # index 0: its transpose is a scatter into one slot;
                    # the broadcast transposes to a plain sum-reduce).
                    ones_b = xp.ones_like(px)
                    l_rgb = Vec3(
                        lights.rgb.x[0] * ones_b,
                        lights.rgb.y[0] * ones_b,
                        lights.rgb.z[0] * ones_b,
                    )
                    contrib = (
                        color
                        * l_rgb
                        * m_kd
                        * (fresnel(u_l, m_ks) * w_l * m_d + (1.0 - m_d))
                    )
                    final_color = final_color + _sanitize3(xp, where3(ok, contrib, zero3))
                    secondary = secondary + ok.astype(xp.int32)

                brdf_b, u_b, pdf_b = brdf_eval_schlick(xp, n_sh, d, new_d, m_rough, m_p)
                pdf_bs = _where(xp, live & (xp.abs(pdf_b) > F32(1e-7)), pdf_b, F32(1.0))
                w_b = brdf_b * xp.maximum(n_sh.dot(new_d), 0.0) / pdf_bs
                mult = _sanitize3(
                    xp, m_kd * (fresnel(u_b, m_ks) * w_b * m_d + (1.0 - m_d))
                )
                color = where3(live, color * mult, color)
            else:
                if nee_enabled:
                    spec_l, diff_l, hk1_l, pdf_l = brdf_eval_sa(xp, n_sh, d, l_dir, m_nu, m_nv)
                    ok = nee_ok & (xp.abs(pdf_l) > F32(1e-5))
                    pdf_ls = _where(xp, ok, pdf_l, F32(1.0))
                    b_s = (spec_l / pdf_ls) * fresnel(hk1_l, m_rs)
                    b_d = (diff_l * m_rd / pdf_ls) * (1.0 - m_rs)
                    bc = m_ks * b_s + m_kd * b_d
                    bc = bc * m_d + (1.0 - m_d)
                    max_rgb = xp.maximum(F32(1.0), bc.max_component())
                    bc = bc / max_rgb
                    bc = Vec3(
                        xp.clip(bc.x, 0.0, 1.0),
                        xp.clip(bc.y, 0.0, 1.0),
                        xp.clip(bc.z, 0.0, 1.0),
                    )
                    # Scalar index + broadcast (NOT a B-lane gather of
                    # index 0: its transpose is a scatter into one slot;
                    # the broadcast transposes to a plain sum-reduce).
                    ones_b = xp.ones_like(px)
                    l_rgb = Vec3(
                        lights.rgb.x[0] * ones_b,
                        lights.rgb.y[0] * ones_b,
                        lights.rgb.z[0] * ones_b,
                    )
                    contrib = bc * l_rgb * m_d + (1.0 - m_d)
                    final_color = final_color + _sanitize3(xp, where3(ok, contrib, zero3))
                    secondary = secondary + ok.astype(xp.int32)

                spec_b, diff_b, hk1_b, pdf_b = brdf_eval_sa(xp, n_sh, d, new_d, m_nu, m_nv)
                pdf_bs = _where(xp, live & (xp.abs(pdf_b) > F32(1e-7)), pdf_b, F32(1.0))
                b_s = (spec_b / pdf_bs) * fresnel(hk1_b, m_rs)
                b_d = (diff_b * m_rd / pdf_bs) * (1.0 - m_rs)
                bc = m_ks * b_s + m_kd * b_d
                bc = bc * m_d + (1.0 - m_d)
                max_rgb = xp.maximum(F32(1.0), bc.max_component())
                bc = bc / max_rgb
                bc = _sanitize3(
                    xp,
                    Vec3(
                        xp.clip(bc.x, 0.0, 1.0),
                        xp.clip(bc.y, 0.0, 1.0),
                        xp.clip(bc.z, 0.0, 1.0),
                    ),
                )
                color = where3(live, color * bc, color)

            # ---- extend depth budget (pathtracing.cl:308) -----------------
            depth_added = depth_added + (
                (add_depth & (depth_added < settings.max_added_depth)) & live
            ).astype(xp.int32)

            # ---- dynamic loop bound (pathtracing.cl:258) ------------------
            alive = alive & ((depth + 1) < settings.max_depth + depth_added)

            # ---- Russian roulette (pt_utils.cl:385-387) -------------------
            max_col = color.max_component()
            rr = (depth > 2 + depth_added) & (max_col < rb.u(S_RR))
            alive = alive & ~rr

            # ---- advance ---------------------------------------------------
            o = where3(live, hit_p, o)
            d = where3(live, new_d, d)
            return (
                o, d, color, alive, light_found, light_val, depth_added,
                final_color, secondary, focus_t, n_path, n_shadow, heat,
                heat_tests, row_frac,
            )

        # Stage 0 = the full batch with the real accumulators; each
        # schedule entry ends the current stage (folding the emission of
        # lanes that died there — a lane with light_found is dead, since
        # alive &= ~miss), gathers the survivors into the next, smaller
        # stage with fresh accumulators, and records the slot mapping so
        # deeper contributions fold back out below.
        carry = (
            o, d, color, alive, light_found, light_val, depth_added,
            final_color, secondary, focus_t, n_path, n_shadow, heat,
            heat_tests, row_frac,
        )
        stage_px, stage_rng, stage_zero3 = px, rng, zero3
        folds = []  # per ended stage: (slot, cap, fc, sec, heat, tests, zero3)
        lo = 0
        for kb, cap in schedule:
            body = functools.partial(bounce_body, stage_px, stage_rng, stage_zero3)
            carry = _run_phase(xp, settings, body, carry, lo, kb)
            (
                o, d, color, alive, light_found, light_val, depth_added,
                fc_s, sec_s, foc_s, n_path, n_shadow, heat_s,
                tests_s, row_frac,
            ) = carry
            fc_s = fc_s + where3(light_found, color * light_val, stage_zero3)
            if lo == 0:
                focus_t = foc_s  # only the full-width stage touches focus
            src, slot, n_ok, n_drop = _compact_rows(xp, alive, block, cap)
            n_drop_total = n_drop_total + n_drop
            folds.append((slot, cap, fc_s, sec_s, heat_s, tests_s, stage_zero3))
            tr = lambda v: _take_rows(xp, v, src, block)  # noqa: E731
            g3 = lambda v: Vec3(tr(v.x), tr(v.y), tr(v.z))  # noqa: E731
            stage_px = tr(stage_px)
            stage_rng = stage_rng.gather_rows(src, block)
            stage_zero3 = Vec3(
                xp.zeros_like(stage_px), xp.zeros_like(stage_px), xp.zeros_like(stage_px)
            )
            # Rows past the live count hold row 0's data — mask them dead.
            valid_row = xp.arange(cap, dtype=xp.int32) < n_ok
            alive_s = tr(alive) & xp.broadcast_to(
                valid_row[:, None], (cap, block)
            ).reshape(-1)
            carry = (
                g3(o), g3(d), g3(color), alive_s,
                xp.zeros_like(alive_s), stage_zero3, tr(depth_added),
                stage_zero3, xp.zeros_like(stage_px, dtype=xp.int32),
                xp.zeros_like(stage_px), n_path, n_shadow,
                xp.zeros_like(stage_px, dtype=xp.int32) if with_stats else None,
                (
                    xp.zeros_like(stage_px, dtype=xp.int32),
                    xp.zeros_like(stage_px, dtype=xp.int32),
                )
                if with_stats
                else None,
                row_frac,
            )
            lo = kb
        body = functools.partial(bounce_body, stage_px, stage_rng, stage_zero3)
        carry = _run_phase(xp, settings, body, carry, lo, settings.max_total_depth)
        (
            _, _, color, _, light_found, light_val, _,
            fc_s, sec_s, foc_s, n_path, n_shadow, heat_s, tests_s, row_frac,
        ) = carry
        fc_s = fc_s + where3(light_found, color * light_val, stage_zero3)
        if not schedule:
            focus_t = foc_s
        # Fold contributions back out through the stage row mappings.
        for slot, cap, fc_prev, sec_prev, heat_prev, tests_prev, zero3_prev in (
            reversed(folds)
        ):
            ok_row = slot < cap  # (R,) rows of the outer stage
            sc = xp.minimum(slot, cap - 1)
            tk = lambda v: _take_rows(xp, v, sc, block)  # noqa: E731
            ok_lane = xp.broadcast_to(
                ok_row[:, None], (ok_row.shape[0], block)
            ).reshape(-1)
            fc_s = fc_prev + where3(
                ok_lane, Vec3(tk(fc_s.x), tk(fc_s.y), tk(fc_s.z)), zero3_prev
            )
            sec_s = sec_prev + xp.where(ok_lane, tk(sec_s), np.int32(0))
            if with_stats:
                heat_s = heat_prev + xp.where(ok_lane, tk(heat_s), np.int32(0))
                tests_s = tuple(
                    p + xp.where(ok_lane, tk(c), np.int32(0))
                    for p, c in zip(tests_prev, tests_s)
                )
        return (
            fc_s, sec_s, focus_t, n_path, n_shadow, heat_s, tests_s,
            row_frac, n_drop_total,
        )

    sample_state = (
        final_color, secondary, focus_t, n_path, n_shadow, heat,
        heat_tests, row_frac, n_drop_total,
    )
    use_scan = (
        xp.__name__.startswith("jax")
        and settings.sample_loop == "scan"
        and settings.samples > 1
    )
    if use_scan:
        import jax

        sample_state, _ = jax.lax.scan(
            lambda c, s: (sample_body(s, c), None),
            sample_state,
            xp.arange(settings.samples, dtype=xp.int32),
        )
    else:
        for s in range(settings.samples):
            sample_state = sample_body(s, sample_state)
    (
        final_color, secondary, focus_t, n_path, n_shadow, heat,
        heat_tests, row_frac, n_drop_total,
    ) = sample_state

    final_color = final_color / secondary.astype(xp.float32)
    if settings.samples > 1:
        final_color = final_color / F32(settings.samples)
    if row_frac is not None and settings.samples > 1:
        row_frac = row_frac / F32(settings.samples)
    return TraceResult(
        color=final_color,
        focus_t=focus_t,
        n_path_rays=n_path,
        n_shadow_rays=n_shadow,
        heat_bounces=heat,
        n_dropped=n_drop_total,
        bounce_row_live=row_frac,
        heat_tests=heat_tests[0] if heat_tests is not None else None,
        heat_visits=heat_tests[1] if heat_tests is not None else None,
    )
