"""GPU measurements behind the intersector constants.

Each phase prints JSON lines (also appended to ``--out`` if given) with the card's
name and power limit; the constants they set cite them:

- ``e2e``: Cornell fwd+bwd frame (gradients w.r.t. materials, lights and
  camera) with each brute form — the fused kernel ('pallas'), the XLA
  ``fori_loop`` sweep ('brute') and the XLA broadcast-and-reduce sweep
  ('dense': 'brute' traced with ``intersect_brute_dense`` swapped in, see
  ``dense_sweep``) — timed in turns A B C C B A inside one process.
- ``crossover``: nearest hit + NEE occlusion of camera and bounce rays,
  kernel against the XLA BVH walk, over a ladder of face counts
  (``ops/traverse.py::GPU_BRUTE_MAX_FACES``); plus a fwd+bwd multiroom frame
  with each.
- ``leaf``: BVH leaf size at soup:100000 — build time and walk time
  (``scene/build.py::LARGE_SCENE_LEAF``).

Run on the GPU (it refuses any other backend):

    python tools/measure_intersect.py [--phases e2e,crossover,leaf] [--scenes ...]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = None
CARD = None


def emit(**rec) -> None:
    rec["card"] = CARD
    line = json.dumps(rec)
    print(line, flush=True)
    if OUT:
        with open(OUT, "a") as f:
            f.write(line + "\n")


def timed(fn, *args, iters: int):
    """(compile+first seconds, [per-call seconds]) with device sync."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, ts


def load(name: str, bvh_cfg=None):
    import jax
    import jax.numpy as jnp

    from pbrjax.scene.build import bvh_max_leaf, scene_from_text
    from pbrjax.scene.camera import make_camera_state
    from pbrjax.scene.procedural import named_scene

    obj, mtl, li, eye = named_scene(name)
    t0 = time.perf_counter()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=True, bvh_cfg=bvh_cfg)
    build_s = time.perf_counter() - t0
    cam = make_camera_state(eye=eye, center_dir=(0.0, 0.0, 1.0))
    return (
        jax.tree_util.tree_map(jnp.asarray, scene),
        jax.tree_util.tree_map(jnp.asarray, cam),
        bvh_max_leaf(scene),
        build_s,
    )


def rays(scene, cam, size: int, n_rays: int, max_leaf: int, seed: int = 0):
    """Camera rays of a size x size image and bounce rays from their hits
    (random directions), each cut to ``n_rays``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pbrjax.models.integrator import _gen_rays
    from pbrjax.ops import rng as rng_mod
    from pbrjax.ops.traverse import intersect_bvh
    from pbrjax.ops.vec import Vec3
    from pbrjax.utils.config import RenderSettings

    settings = RenderSettings(width=size, height=size)
    ids = jnp.arange(size * size, dtype=jnp.int32)[:n_rays]
    px = (ids % size).astype(jnp.float32)
    py = (ids // size).astype(jnp.float32)
    rng = rng_mod.PixelRng(jnp.uint32(seed), ids.astype(jnp.uint32))
    o, d = _gen_rays(jnp, cam, settings, px, py, rng, 0, jnp.full(px.shape, jnp.inf))
    t, _ = jax.jit(
        lambda sc, o, d: intersect_bvh(jnp, o, d, sc.bvh, sc.tris, max_leaf=max_leaf)
    )(scene, o, d)
    hit = jnp.isfinite(t)
    h = o + d * jnp.where(hit, t, 0.0)
    dn = np.random.default_rng(seed).normal(size=(3, o.x.shape[0])).astype(np.float32)
    dn /= np.linalg.norm(dn, axis=0, keepdims=True)
    return (o, d), (h, Vec3(*(jnp.asarray(c) for c in dn)))


@functools.lru_cache(maxsize=None)
def isect_fn(mode: str, max_leaf: int):
    """jit: nearest hit + NEE occlusion as the integrator runs them."""
    import jax
    import jax.numpy as jnp

    from pbrjax.models.integrator import _shadow_occluded
    from pbrjax.ops.traverse import intersect_scene
    from pbrjax.ops.vec import Vec3, safe_div, safe_sqrt

    def f(scene, o, d):
        lp = Vec3(scene.lights.pos.x[0], scene.lights.pos.y[0], scene.lights.pos.z[0])
        t, face, occ = intersect_scene(jnp, o, d, scene, max_leaf=max_leaf,
                                       mode=mode, light_pos=lp)
        if occ is None:
            hit_p = o + d * jnp.where(jnp.isfinite(t), t, 1.0)
            ones = jnp.ones_like(t)
            l_vec = Vec3(lp.x * ones, lp.y * ones, lp.z * ones) - hit_p
            t_light = safe_sqrt(l_vec.length2())
            l_dir = l_vec * safe_div(jnp.float32(1.0), t_light)
            occ = _shadow_occluded(jnp, scene, hit_p, l_dir, t_light, max_leaf, mode)
        return face, occ

    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def walk_fn(max_leaf: int):
    """jit: the BVH walk's nearest hit over the whole batch."""
    import jax
    import jax.numpy as jnp

    from pbrjax.ops.traverse import intersect_bvh

    return jax.jit(lambda sc, o, d: intersect_bvh(
        jnp, o, d, sc.bvh, sc.tris, max_leaf=max_leaf))


@contextlib.contextmanager
def dense_sweep():
    """While a step traces, the 'brute' mode runs the broadcast (B, F)
    sweep ``intersect_brute_dense`` instead of the ``fori_loop`` one."""
    from pbrjax.ops import traverse

    fori = traverse.intersect_brute
    traverse.intersect_brute = traverse.intersect_brute_dense
    try:
        yield
    finally:
        traverse.intersect_brute = fori


def fwdbwd_step(scene, cam, max_leaf, size, mode):
    """jit: Cornell-style fwd+bwd frame with intersector ``mode`` (or
    'dense', see ``dense_sweep``)."""
    import jax
    import jax.numpy as jnp

    from pbrjax.models.integrator import trace_rays
    from pbrjax.scene.build import derive_static_flags
    from pbrjax.utils.config import RenderSettings

    settings = derive_static_flags(scene, RenderSettings(
        width=size, height=size, samples=1, max_depth=3, max_added_depth=5,
        shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0),
        intersector="brute" if mode == "dense" else mode,
    ))
    ids = jnp.arange(size * size, dtype=jnp.int32)
    sweep = dense_sweep if mode == "dense" else contextlib.nullcontext

    @jax.jit
    def step(scene, cam, seed):
        def loss(params):
            mats, lights, camst = params
            sc = scene._replace(materials=mats, lights=lights)
            with sweep():
                res = trace_rays(jnp, sc, camst, settings, ids, seed, max_leaf=max_leaf)
            return res.color.x.sum() + res.color.y.sum() + res.color.z.sum()

        return jax.value_and_grad(loss, allow_int=True)(
            (scene.materials, scene.lights, cam)
        )

    return step


def phase_e2e(args):
    import jax.numpy as jnp

    scene, cam, ml, _ = load("cornell")
    modes = ("pallas", "brute", "dense")
    steps = {m: fwdbwd_step(scene, cam, ml, args.size, m) for m in modes}
    runs = {m: [] for m in modes}
    for m in modes:
        first, _ = timed(steps[m], scene, cam, jnp.uint32(1), iters=0)
        emit(phase="e2e", scene="cornell", mode=m, size=args.size, compile_s=first)
    for m in modes + modes[::-1]:  # in turns: A B C C B A
        _, ts = timed(steps[m], scene, cam, jnp.uint32(2), iters=args.iters)
        runs[m] += ts
    for m in modes:
        emit(phase="e2e", scene="cornell", mode=m, size=args.size,
             fwdbwd_ms_median=1e3 * statistics.median(runs[m]),
             fwdbwd_ms_min=1e3 * min(runs[m]), n=len(runs[m]))


def phase_crossover(args):
    import jax.numpy as jnp

    for name in args.scenes.split(","):
        scene, cam, ml, _ = load(name)
        prim, bounce = rays(scene, cam, args.size, args.rays, ml)
        for kind, (o, d) in (("camera", prim), ("bounce", bounce)):
            for mode in ("pallas", "bvh"):
                first, ts = timed(isect_fn(mode, ml), scene, o, d, iters=args.iters)
                emit(phase="crossover", scene=name, faces=int(scene.tris.count),
                     rays=int(o.x.shape[0]), kind=kind, mode=mode,
                     isect_nee_ms_median=1e3 * statistics.median(ts),
                     isect_nee_ms_min=1e3 * min(ts))
    scene, cam, ml, _ = load("multiroom")
    for mode in ("pallas", "bvh"):
        first, ts = timed(fwdbwd_step(scene, cam, ml, args.size, mode), scene, cam,
                          jnp.uint32(1), iters=args.iters)
        emit(phase="crossover", scene="multiroom", mode=mode, size=args.size,
             compile_s=first, fwdbwd_ms_median=1e3 * statistics.median(ts))


def phase_leaf(args):
    from pbrjax.utils.config import BVHConfig

    n_rays = args.rays // 4
    for leaf in (4, 8, 16, 32):
        scene, cam, ml, build_s = load("soup:100000", BVHConfig(max_faces=leaf))
        _, (o, d) = rays(scene, cam, args.size, n_rays, ml)
        _, ts = timed(walk_fn(ml), scene, o, d, iters=args.iters)
        emit(phase="leaf", scene="soup:100000", leaf=leaf, max_leaf=ml,
             nodes=int(scene.bvh.count), build_s=build_s, rays=n_rays,
             walk_ms_median=1e3 * statistics.median(ts))


def main() -> None:
    global OUT, CARD
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="e2e,crossover,leaf")
    ap.add_argument("--scenes", default="soup:1024,multiroom,soup:4096,soup:8192,"
                    "soup:16384,soup:32768,soup:65536,soup:100000",
                    help="the crossover phase's face-count ladder")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=None, help="also append the JSON lines here")
    args = ap.parse_args()

    from pbrjax.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"measure_intersect: needs a GPU, found {dev.platform}")
    OUT = args.out
    if OUT:
        os.makedirs(os.path.dirname(OUT) or ".", exist_ok=True)
    from pbrjax.utils.profiling import gpu_card

    CARD = gpu_card()
    print(CARD, flush=True)
    emit(phase="device", kind=dev.device_kind, count=len(jax.devices()))
    for p in args.phases.split(","):
        t0 = time.perf_counter()
        try:
            globals()[f"phase_{p}"](args)
        except Exception as e:  # keep the other phases' numbers
            emit(phase=p, error=f"{type(e).__name__}: {str(e)[:2000]}")
        emit(phase=p, wall_s=time.perf_counter() - t0)


if __name__ == "__main__":
    main()
