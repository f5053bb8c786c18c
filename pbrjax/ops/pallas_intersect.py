"""Fused brute-force intersection kernel (Pallas, Triton route, GPU).

Why: the XLA ``fori_loop`` sweep (``ops.traverse.intersect_brute``) runs
one fused pass over the whole ray batch per face, so ``t_best``/``face``
and the ray state make a round trip through device memory on every face
iteration. This kernel gives each program a power-of-two block of rays,
keeps ``t_best``/``face`` in registers for the whole face loop, and reads
the face table through the cache: device-memory traffic is 7 words in and
2-3 words out per ray, whatever the face count.

The NEE shadow any-hit runs in the same pass (``light_pos``): each ray
derives its hit point and light direction with the integrator's guarded
math and sweeps the faces again with ``t < t_light``, so a ray is read
once per bounce for both legs.

Same Möller-Trumbore math and first-face-wins tie-breaking as
``ops.intersect.moller_trumbore`` / ``ops.traverse.intersect_brute`` (the
vectorized re-design of the reference's pt_intersect.cl:92-129), so it is
interchangeable with the other intersectors behind ``intersect_scene``.

Layout contract: the flat ray batch is padded to a multiple of ``BLOCK``;
the (16, F_pad) face table has rows v0/e1/e2 (9 used) and F_pad the next
power of two of the face count (Triton block shapes are powers of two).
"""

from __future__ import annotations

import functools

import numpy as np

from pbrjax.ops.intersect import INF
from pbrjax.ops.vec import Vec3
from pbrjax.scene.types import TrianglesSoA
from pbrjax.utils.config import EPSILON5

# Rays per program. With 4 warps (128 threads) each thread carries two rays
# through the face loop; 1024² rays make 4096 programs for 132 SMs.
BLOCK = 256
NUM_WARPS = 4
_TAB_ROWS = 16


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _mt(tab_ref, f, ox, oy, oz, dx, dy, dz):
    """Möller-Trumbore of one face (scalar table reads) against the block:
    ``(t, valid)`` with the reference's gates (pt_intersect.cl:92-129)."""
    v0x, v0y, v0z = tab_ref[0, f], tab_ref[1, f], tab_ref[2, f]
    e1x, e1y, e1z = tab_ref[3, f], tab_ref[4, f], tab_ref[5, f]
    e2x, e2y, e2z = tab_ref[6, f], tab_ref[7, f], tab_ref[8, f]
    # pvec = d x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / det
    # tvec = o - v0 ; qvec = tvec x e1
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    u = (tx * px + ty * py + tz * pz) * inv_det
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    valid = (t >= np.float32(EPSILON5)) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, valid


def _kernel(nf, nee, *refs):
    """One block of rays against all ``nf`` faces (and, with ``nee``, the
    light-0 shadow any-hit from each hit point)."""
    import jax
    import jax.numpy as jnp

    if nee:
        (tab_ref, lp_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
         alive_ref, t_ref, f_ref, occ_ref) = refs
    else:
        (tab_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
         alive_ref, t_ref, f_ref) = refs
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    alive_i = alive_ref[...]
    alive = alive_i != 0
    # A block whose lanes are all dead skips the face loops entirely.
    n = jnp.where(jnp.max(alive_i) > 0, np.int32(nf), np.int32(0))

    def nearest(f, carry):
        t_best, f_best = carry
        t, valid = _mt(tab_ref, f, ox, oy, oz, dx, dy, dz)
        ok = valid & (t < t_best)
        return jnp.where(ok, t, t_best), jnp.where(ok, f, f_best)

    t_best, f_best = jax.lax.fori_loop(
        np.int32(0), n, nearest,
        (jnp.full(ox.shape, INF, jnp.float32), jnp.full(ox.shape, -1, jnp.int32)),
    )
    t_best = jnp.where(alive, t_best, INF)
    t_ref[...] = t_best
    f_ref[...] = jnp.where(alive, f_best, -1)
    if not nee:
        return

    # Shadow leg: exactly the integrator's guarded math (t_safe for missed
    # lanes, safe_sqrt / safe_div semantics), then occluded iff some face
    # lies closer than the light (traverseShadows, pt_bvh.cl:133-177).
    one = np.float32(1.0)
    hit = t_best < INF
    ts = jnp.where(hit, t_best, one)
    hx = ox + dx * ts
    hy = oy + dy * ts
    hz = oz + dz * ts
    lx = lp_ref[0] - hx
    ly = lp_ref[1] - hy
    lz = lp_ref[2] - hz
    len2 = lx * lx + ly * ly + lz * lz
    pos = len2 > 0.0
    t_light = jnp.where(pos, jnp.sqrt(jnp.where(pos, len2, one)), 0.0)
    okd = jnp.abs(t_light) > np.float32(1e-12)
    inv = jnp.where(okd, one / jnp.where(okd, t_light, one), 0.0)
    sx, sy, sz = lx * inv, ly * inv, lz * inv
    n_sh = jnp.where(jnp.max(hit.astype(jnp.int32)) > 0, n, np.int32(0))

    def shadow(f, occ):
        t, valid = _mt(tab_ref, f, hx, hy, hz, sx, sy, sz)
        return occ | (valid & (t < t_light))

    occ = jax.lax.fori_loop(np.int32(0), n_sh, shadow, jnp.zeros(ox.shape, jnp.bool_))
    occ_ref[...] = (occ & hit).astype(jnp.int32)


@functools.lru_cache(maxsize=None)
def _build_call(nf: int, f_pad: int, n_rays: int, nee: bool, interpret: bool,
                vma: tuple):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    in_specs = [pl.BlockSpec((_TAB_ROWS, f_pad), lambda i: (0, 0))]
    if nee:
        in_specs.append(pl.BlockSpec((4,), lambda i: (0,)))
    in_specs += [ray_spec] * 7
    kw = {"vma": frozenset(vma)} if vma else {}
    out_shape = [
        jax.ShapeDtypeStruct((n_rays,), jnp.float32, **kw),
        jax.ShapeDtypeStruct((n_rays,), jnp.int32, **kw),
    ]
    if nee:
        out_shape.append(jax.ShapeDtypeStruct((n_rays,), jnp.int32, **kw))
    return pl.pallas_call(
        functools.partial(_kernel, nf, nee),
        grid=(n_rays // BLOCK,),
        in_specs=in_specs,
        out_specs=tuple([ray_spec] * len(out_shape)),
        out_shape=tuple(out_shape),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="pbr_intersect_nee" if nee else "pbr_intersect",
    )


def _pvary(x, vma: tuple):
    import jax

    missing = tuple(a for a in vma if a not in jax.typeof(x).vma)
    return jax.lax.pcast(x, missing, to="varying") if missing else x


def face_table(tris: TrianglesSoA):
    """(16, F_pad) f32 kernel face table: rows v0.xyz, e1.xyz, e2.xyz, then
    zeros; padding faces are all-zero (det = 0, never valid)."""
    import jax.numpy as jnp

    nf = int(tris.mtl.shape[0])
    f_pad = _next_pow2(max(nf, 1))
    rows = [
        tris.v0.x, tris.v0.y, tris.v0.z,
        tris.e1.x, tris.e1.y, tris.e1.z,
        tris.e2.x, tris.e2.y, tris.e2.z,
    ]
    tab = jnp.stack([jnp.asarray(r, jnp.float32) for r in rows], axis=0)
    return jnp.pad(tab, ((0, _TAB_ROWS - len(rows)), (0, f_pad - nf)))


def intersect_pallas(
    xp, o: Vec3, d: Vec3, tris: TrianglesSoA, light_pos=None, alive=None,
    interpret: bool = False,
):
    """Nearest hit over all triangles in one kernel pass. jax-only.

    Returns ``(t, face)``, or ``(t, face, occluded)`` with ``light_pos`` (a
    scalar Vec3, light 0). Lanes with ``alive`` False report a miss and
    are never occluded. The search is not differentiable: callers detach
    it and re-evaluate the winner (``ops.traverse.intersect_scene``).
    ``interpret`` runs the kernel in the Pallas interpreter (CPU tests).
    """
    import jax
    import jax.numpy as jnp

    nf = int(tris.mtl.shape[0])
    shape = o.x.shape
    flat = int(np.prod(shape)) if shape else 1
    pad = (-flat) % BLOCK
    n_rays = flat + pad

    def prep(a, dtype=jnp.float32):
        a = jnp.asarray(a, dtype).reshape(-1)
        return jnp.pad(a, (0, pad)) if pad else a

    if alive is None:
        alive = jnp.ones(shape, jnp.int32)
    rays = [prep(a) for a in (o.x, o.y, o.z, d.x, d.y, d.z)]
    rays.append(prep(alive, jnp.int32))  # padding lanes are dead
    args = [face_table(tris)]
    if light_pos is not None:
        args.append(jnp.stack([
            jnp.asarray(light_pos.x, jnp.float32),
            jnp.asarray(light_pos.y, jnp.float32),
            jnp.asarray(light_pos.z, jnp.float32),
            jnp.float32(0.0),
        ]))
    # Inside shard_map the scene is replicated and the rays are not: give
    # every operand the rays' varying axes, as pallas_call expects.
    vma = tuple(sorted(jax.typeof(rays[0]).vma))
    args = [jax.lax.stop_gradient(_pvary(a, vma)) for a in args]
    call = _build_call(nf, args[0].shape[1], n_rays, light_pos is not None,
                       interpret, vma)
    outs = call(*args, *rays)
    unflat = lambda a: a[:flat].reshape(shape)  # noqa: E731
    if light_pos is not None:
        t, f, occ = outs
        return unflat(t), unflat(f), unflat(occ) != 0
    t, f = outs
    return unflat(t), unflat(f)
