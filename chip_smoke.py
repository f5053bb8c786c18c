"""Smoke run of the renderer's main path on one NVIDIA GPU.

    python chip_smoke.py           # phases 1-5 on one GPU
    python chip_smoke.py --four    # phase 6 only: dp=4 over four GPUs

Everything runs in this one process (a JAX process reserves most of a
card's memory), with the persistent compile cache enabled first. Phases:

1. The fused brute kernel (ops/pallas_intersect.py) against the plain
   ``intersect_brute`` on ~1M camera and bounce rays: Cornell and a soup
   at the kernel's face-count limit, nearest hit and NEE occlusion.
2. Cornell 1024² forward frames through ``PathTracer``; a 128² frame
   against the NumPy oracle (``reference/cpu.py::render_cpu``).
3. Cornell 1024² fwd+bwd (gradients w.r.t. materials, lights, camera);
   at 64², the kernel's step against the plain sweep's on the GPU and the
   same jitted step on the CPU (tolerances in ``phase_cornell_fwdbwd``).
4. multiroom 1024² fwd+bwd (as dispatched, and forced onto the BVH walk)
   with the 128² oracle gate; soup:100000 1024² forward frame (the walk)
   with its BVH build time.
5. The ``fit`` CLI, in-process, for a few steps: the loss must fall.
6. (``--four``) ``sharded_train_step`` and ``sharded_render`` on a dp=4
   mesh of four GPUs against the same calls on one GPU (the train step
   per dp shard, summed in float64; tolerances in ``phase_four``).

Every phase prints its dispatch choice and times next to the card's name
and power limit. Any failing phase makes the exit code non-zero. There is
no CPU fallback: without a GPU it exits non-zero before any phase. The
last line of a passing run is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import traceback

SIZE = 1024  # the benchmark resolution
ORACLE_SIZE = 128  # NumPy oracle gate resolution
PARITY_SIZE = 64  # GPU/CPU step parity resolution
BIG_SOUP = "soup:100000"  # BASELINE config 5
CARD = ""


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, *args, iters: int = 3):
    """(compile+first seconds, median steady seconds, last output)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, statistics.median(ts), out


def report_time(what: str, first: float, steady: float) -> None:
    log(f"  {what}: compile+first {first:.2f} s, steady {steady * 1e3:.2f} ms "
        f"[{CARD}]")


def load(name: str):
    """(host scene, camera) of a repo-resident scene."""
    from pbrjax.scene.build import scene_from_text
    from pbrjax.scene.camera import make_camera_state
    from pbrjax.scene.procedural import named_scene

    obj, mtl, li, eye = named_scene(name)
    t0 = time.perf_counter()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=True)
    log(f"  {name}: {scene.tris.count} faces, BVH of {scene.bvh.count} nodes "
        f"built in {time.perf_counter() - t0:.2f} s")
    return scene, make_camera_state(eye=eye, center_dir=(0.0, 0.0, 1.0))


def settings_for(scene, size: int, **kw):
    """BASELINE render settings: 1 spp, max_depth 3 + 5 extensions, NEE."""
    from pbrjax.scene.build import derive_static_flags
    from pbrjax.utils.config import RenderSettings

    base = dict(width=size, height=size, samples=1, max_depth=3,
                max_added_depth=5, shadow_rays=1, anti_aliasing=0.7,
                sky_light=(0.85, 0.9, 1.0))
    base.update(kw)
    return derive_static_flags(scene, RenderSettings(**base))


def dispatch(scene) -> str:
    from pbrjax.ops.traverse import select_intersector

    return select_intersector("gpu", scene.tris.count, scene.bvh is not None)


def to_dev(tree, device=None):
    import jax
    import jax.numpy as jnp

    if device is None:
        return jax.tree_util.tree_map(jnp.asarray, tree)
    return jax.device_put(jax.tree_util.tree_map(jnp.asarray, tree), device)


# ---- phase 1 ---------------------------------------------------------------

def _test_rays(js, jc, size: int):
    """~size² rays: half camera rays, half bounce rays from their hits in
    random directions."""
    import jax.numpy as jnp
    import numpy as np

    from pbrjax.models.integrator import _gen_rays
    from pbrjax.ops import rng as rng_mod
    from pbrjax.ops.traverse import intersect_brute
    from pbrjax.ops.vec import Vec3
    from pbrjax.utils.config import RenderSettings

    n = size * size // 2
    ids = jnp.arange(size * size, dtype=jnp.int32)[::2]
    px = (ids % size).astype(jnp.float32)
    py = (ids // size).astype(jnp.float32)
    rng = rng_mod.PixelRng(jnp.uint32(1), ids.astype(jnp.uint32))
    o, d = _gen_rays(jnp, jc, RenderSettings(width=size, height=size), px, py,
                     rng, 0, jnp.full(px.shape, jnp.inf))
    t, _ = intersect_brute(jnp, o, d, js.tris)
    h = o + d * jnp.where(jnp.isfinite(t), t, 0.0)
    dn = np.random.default_rng(7).normal(size=(3, n)).astype(np.float32)
    dn /= np.linalg.norm(dn, axis=0, keepdims=True)
    cat = lambda a, b: jnp.concatenate([a, b])  # noqa: E731
    return (Vec3(cat(o.x, h.x), cat(o.y, h.y), cat(o.z, h.z)),
            Vec3(cat(d.x, jnp.asarray(dn[0])), cat(d.y, jnp.asarray(dn[1])),
                 cat(d.z, jnp.asarray(dn[2]))))


def phase_kernel(args) -> None:
    """Kernel vs intersect_brute on the card. Tolerance: the same face on
    >= 99.99% of rays and t within 1e-5 relative where the faces agree;
    NEE occlusion equal on >= 99.99% of the agreeing hits. Both sides run
    the same float32 Möller-Trumbore (no matmul, so no TF32); they differ
    only in FMA contraction and division rounding, which can flip a
    grazing hit between adjacent faces."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pbrjax.ops.pallas_intersect import intersect_pallas
    from pbrjax.ops.traverse import GPU_BRUTE_MAX_FACES, intersect_brute
    from pbrjax.ops.vec import Vec3, safe_div, safe_sqrt

    @jax.jit
    def kernel(tris, o, d, lp):
        return intersect_pallas(jnp, o, d, tris, light_pos=lp)

    @jax.jit
    def plain(tris, o, d, lp):
        t, f = intersect_brute(jnp, o, d, tris)
        hit_p = o + d * jnp.where(jnp.isfinite(t), t, 1.0)
        ones = jnp.ones_like(t)
        l_vec = Vec3(lp.x * ones, lp.y * ones, lp.z * ones) - hit_p
        t_light = safe_sqrt(l_vec.length2())
        l_dir = l_vec * safe_div(jnp.float32(1.0), t_light)
        t_sh, _ = intersect_brute(jnp, hit_p, l_dir, tris)
        return t, f, (t_sh < t_light) & jnp.isfinite(t)

    cam_scene, cam = load("cornell")
    jcam = to_dev(cam)
    for name in ("cornell", f"soup:{GPU_BRUTE_MAX_FACES}"):
        scene, _ = load(name) if name != "cornell" else (cam_scene, cam)
        js = to_dev(scene)
        o, d = _test_rays(js, jcam, SIZE)
        lp = Vec3(js.lights.pos.x[0], js.lights.pos.y[0], js.lights.pos.z[0])
        log(f"  {name}: dispatch '{dispatch(scene)}', {o.x.shape[0]} rays")
        first, steady, (t_k, f_k, occ_k) = timed(kernel, js.tris, o, d, lp)
        report_time("kernel nearest+NEE", first, steady)
        first, steady, (t_b, f_b, occ_b) = timed(plain, js.tris, o, d, lp)
        report_time("intersect_brute nearest + shadow sweep", first, steady)
        t_k, f_k, occ_k, t_b, f_b, occ_b = (
            np.asarray(a) for a in (t_k, f_k, occ_k, t_b, f_b, occ_b))
        same = f_k == f_b
        hit = same & (f_b >= 0)
        rel = np.abs(t_k[hit] - t_b[hit]) / np.maximum(np.abs(t_b[hit]), 1e-30)
        occ_agree = (occ_k[hit] == occ_b[hit]).mean()
        log(f"  {name}: face agreement {same.mean():.6f}, max rel t diff "
            f"{rel.max() if rel.size else 0.0:.2e}, occlusion agreement "
            f"{occ_agree:.6f}")
        assert same.mean() >= 0.9999, same.mean()
        assert rel.size == 0 or rel.max() <= 1e-5, rel.max()
        assert occ_agree >= 0.9999, occ_agree


# ---- phases 2-4 ------------------------------------------------------------

def oracle_gate(scene, cam, name: str) -> None:
    """128² device frame vs the NumPy oracle: >= 99% of pixels within 1e-3
    (tests/test_render_golden.py; a ULP can flip a rare discrete path
    decision, so the gate is percentile-based)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pbrjax.models.integrator import trace_rays
    from pbrjax.reference.cpu import render_cpu
    from pbrjax.scene.build import bvh_max_leaf

    s = settings_for(scene, ORACLE_SIZE)
    ml = bvh_max_leaf(scene)
    ids = jnp.arange(s.width * s.height, dtype=jnp.int32)
    res = jax.jit(lambda sc, c: trace_rays(jnp, sc, c, s, ids, jnp.uint32(3),
                                           max_leaf=ml).color)(to_dev(scene), to_dev(cam))
    rgb = np.stack([np.asarray(res.x), np.asarray(res.y), np.asarray(res.z)], -1)
    rgb = rgb.reshape(s.height, s.width, 3)
    t0 = time.perf_counter()
    ref, _ = render_cpu(scene, cam, s, frame_seed=3, max_leaf=ml)
    d = np.abs(rgb - ref).max(axis=-1)
    flips = float((d > 1e-3).mean())
    log(f"  {name} {ORACLE_SIZE}² vs oracle: {flips:.4%} pixels beyond 1e-3 "
        f"(oracle {time.perf_counter() - t0:.1f} s)")
    assert np.isfinite(rgb).all()
    assert flips <= 0.01, flips


def fwdbwd_step(settings, max_leaf: int, ids):
    """jit: loss = sum of colors, value_and_grad w.r.t. (materials, lights,
    camera) — the benchmark's differentiable frame."""
    import jax
    import jax.numpy as jnp

    from pbrjax.models.integrator import trace_rays

    @jax.jit
    def step(scene, cam, seed):
        def loss(params):
            mats, lights, camst = params
            sc = scene._replace(materials=mats, lights=lights)
            res = trace_rays(jnp, sc, camst, settings, ids, seed, max_leaf=max_leaf)
            return res.color.x.sum() + res.color.y.sum() + res.color.z.sum()

        return jax.value_and_grad(loss, allow_int=True)(
            (scene.materials, scene.lights, cam))

    return step


def float_leaves(tree):
    import jax
    import numpy as np

    return [np.asarray(g) for g in jax.tree_util.tree_leaves(tree)
            if hasattr(g, "dtype") and g.dtype != jax.dtypes.float0]


def run_fwdbwd(scene, cam, name: str, intersector: str = "auto"):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pbrjax.scene.build import bvh_max_leaf

    size = SIZE
    s = settings_for(scene, size, intersector=intersector)
    step = fwdbwd_step(s, bvh_max_leaf(scene), jnp.arange(size * size, dtype=jnp.int32))
    js, jc = to_dev(scene), to_dev(cam)
    compiled = step.lower(js, jc, jnp.uint32(1)).compile()
    mode = dispatch(scene) if intersector == "auto" else intersector
    log(f"  {name} {size}² fwd+bwd, intersector '{mode}': "
        f"memory_analysis {compiled.memory_analysis()}")
    first, steady, (loss, grads) = timed(step, js, jc, jnp.uint32(1))
    report_time(f"{name} {size}² fwd+bwd", first, steady)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use')} of "
        f"bytes_limit {stats.get('bytes_limit')}")
    leaves = float_leaves(grads)
    assert np.isfinite(float(loss)) and all(np.isfinite(g).all() for g in leaves)
    log(f"  loss {float(loss):.6g}; {len(leaves)} gradient leaves, all finite")


def phase_cornell_forward(args) -> None:
    import jax

    from pbrjax.models.pathtracer import PathTracer

    scene, cam = load("cornell")
    s = settings_for(scene, SIZE)
    pt = PathTracer(scene, s)
    log(f"  cornell {SIZE}² forward via PathTracer, dispatch '{dispatch(scene)}', "
        f"lane order {pt.lane_order}")
    ts = []
    for i in range(4):
        t0 = time.perf_counter()
        pt.render(cam, frame_seed=i)
        jax.block_until_ready(pt.state.rgb.x)
        ts.append(time.perf_counter() - t0)
    report_time(f"cornell {SIZE}² frame", ts[0], statistics.median(ts[1:]))
    img = pt.image()
    assert img.shape == (SIZE, SIZE, 3) and (img >= 0).all() and img.max() > 0
    oracle_gate(scene, cam, "cornell")


def _leaf_diff(a_leaves, b_leaves):
    """(largest |b| entry, largest |a - b| over all entries, that entry's
    (a, b) values)."""
    import numpy as np

    scale = max(float(np.abs(b).max()) for b in b_leaves)
    worst = (0.0, 0.0, 0.0)
    for a, b in zip(a_leaves, b_leaves):
        i = int(np.abs(a - b).argmax())
        d = float(np.abs(a - b).flat[i])
        if d >= worst[0]:
            worst = (d, float(a.flat[i]), float(b.flat[i]))
    return scale, worst[0], worst[1:]


def phase_cornell_fwdbwd(args) -> None:
    """Cornell 1024² fwd+bwd; then the 64² step on the GPU against the
    same jitted step on the CPU.

    - BASELINE settings, seeds 4, 5 and 6, the GPU step as dispatched (the
      kernel) and forced onto the plain 'brute' sweep the CPU runs. Kernel
      vs 'brute' on the card: loss within 1e-6 relative and every gradient
      leaf within 1e-6 x the largest gradient entry, since the kernel
      finds the same faces, distances and occlusion bitwise (phase 1) and
      the rest of the step is the same program. GPU vs CPU: loss within
      5e-3 relative, gradients finite. The two platforms run the same
      program with other libm, fusion and FMA contraction, so a ULP can
      flip a rare discrete path decision (extension, roulette, a grazing
      hit) and move that pixel by O(its value): 5e-3 of the frame sum is
      the oracle gate's flip budget. Gradient leaves that sum per-pixel
      terms of both signs (light position, camera) can move by more than
      their own size; the printed per-seed readings show whether such a
      gap follows the seed (flipped paths) or the intersector.
    - max_depth 2, no extensions (primary hit, NEE, one sampled bounce; no
      roulette): no such decisions are left but grazing hits, so every
      gradient leaf agrees within rtol 1e-3 + 1e-3 x the largest gradient
      entry. Position and camera gradients sum per-pixel terms of both
      signs, so they are compared at this scale, not their own.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pbrjax.scene.build import bvh_max_leaf

    scene, cam = load("cornell")
    run_fwdbwd(scene, cam, "cornell")
    ml = bvh_max_leaf(scene)
    cpu = jax.devices("cpu")[0]
    ids = lambda: jnp.arange(PARITY_SIZE**2, dtype=jnp.int32)  # noqa: E731
    js, jc = to_dev(scene), to_dev(cam)
    cs, cc = to_dev(scene, cpu), to_dev(cam, cpu)

    def gpu_cpu(s, seed, modes=("auto",)):
        """{mode: (loss, float leaves)} on the GPU, and the CPU's."""
        out = {}
        for mode in modes:
            step = fwdbwd_step(s.replace(intersector=mode), ml, ids())
            loss, g = step(js, jc, jnp.uint32(seed))
            out[mode] = (float(loss), float_leaves(g))
        with jax.default_device(cpu):  # the trace's dispatch follows the device
            loss, g = fwdbwd_step(s, ml, ids())(cs, cc, jax.device_put(jnp.uint32(seed), cpu))
        return out, (float(loss), float_leaves(g))

    def compare(tag, a, b):
        rel = abs(a[0] - b[0]) / abs(b[0])
        scale, diff, (va, vb) = _leaf_diff(a[1], b[1])
        log(f"    {tag}: loss rel diff {rel:.3e}; largest gradient diff "
            f"{diff:.4g} ({va:.6g} vs {vb:.6g}) = {diff / scale:.3e} of the "
            f"largest entry {scale:.4g}")
        return rel, diff / scale

    s = settings_for(scene, PARITY_SIZE)
    for seed in (4, 5, 6):
        log(f"  {PARITY_SIZE}² BASELINE, seed {seed}:")
        gpu, cpu_out = gpu_cpu(s, seed, modes=("auto", "brute"))
        rel_kb, diff_kb = compare(f"GPU '{dispatch(scene)}' vs GPU 'brute'",
                                  gpu["auto"], gpu["brute"])
        rel_kc, _ = compare("GPU kernel vs CPU", gpu["auto"], cpu_out)
        rel_bc, _ = compare("GPU 'brute' vs CPU", gpu["brute"], cpu_out)
        assert all(np.isfinite(g).all() for g in gpu["auto"][1] + gpu["brute"][1]
                   + cpu_out[1])
        assert rel_kb <= 1e-6 and diff_kb <= 1e-6, (rel_kb, diff_kb)
        assert rel_kc <= 5e-3 and rel_bc <= 5e-3, (rel_kc, rel_bc)

    s = settings_for(scene, PARITY_SIZE, max_depth=2, max_added_depth=0)
    log(f"  {PARITY_SIZE}² depth 2, seed 4:")
    gpu, cpu_out = gpu_cpu(s, 4)
    rel, _ = compare("GPU kernel vs CPU", gpu["auto"], cpu_out)
    assert all(np.isfinite(g).all() for g in gpu["auto"][1] + cpu_out[1])
    assert rel <= 1e-3, rel
    scale = max(float(np.abs(b).max()) for b in cpu_out[1])
    for a, b in zip(gpu["auto"][1], cpu_out[1]):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * scale)


def phase_bvh_scenes(args) -> None:
    import jax
    import jax.numpy as jnp

    from pbrjax.models.integrator import trace_rays
    from pbrjax.scene.build import bvh_max_leaf

    scene, cam = load("multiroom")
    run_fwdbwd(scene, cam, "multiroom")
    run_fwdbwd(scene, cam, "multiroom", intersector="bvh")  # the walk, with grads
    oracle_gate(scene, cam, "multiroom")

    scene, cam = load(BIG_SOUP)
    s = settings_for(scene, SIZE, sky_light=(0.8, 0.9, 1.0))
    ml = bvh_max_leaf(scene)
    ids = jnp.arange(SIZE * SIZE, dtype=jnp.int32)
    fwd = jax.jit(lambda sc, c, seed: trace_rays(jnp, sc, c, s, ids, seed,
                                                 max_leaf=ml).color)
    log(f"  {BIG_SOUP} {SIZE}² forward, dispatch '{dispatch(scene)}', "
        f"max_leaf {ml}")
    first, steady, color = timed(fwd, to_dev(scene), to_dev(cam), jnp.uint32(1),
                                 iters=2)
    report_time(f"{BIG_SOUP} {SIZE}² forward frame", first, steady)
    assert bool(jnp.isfinite(color.x).all()) and float(color.x.max()) > 0


def phase_fit(args) -> None:
    from pbrjax.app import main as app_main

    t0 = time.perf_counter()
    res = app_main(["fit", "--steps", "8"])
    log(f"  fit cornell 64² 8 steps: loss {res['loss0']:.6f} -> {res['loss']:.6f}, "
        f"max albedo error {res['albedo_err']:.4f} ({time.perf_counter() - t0:.1f} s "
        f"with compile) [{CARD}]")
    assert res["loss"] < res["loss0"], res


# ---- phase 6 ---------------------------------------------------------------

def phase_four(args) -> None:
    """dp=4 over four GPUs against the same step on one GPU.

    Train step: the reference is the one-GPU step run on each dp shard's
    pixels (``pixel_ids``), its four losses and gradients summed in float64
    on the host: the same per-pixel program, with the cross-shard sum done
    exactly. The loss agrees within rtol 2e-5 and every gradient leaf
    within rtol 2e-4, plus 4 float32 ulps of the shards' summed magnitudes
    (the rounding of a 4-term float32 psum, for a leaf whose shard terms
    cancel).

    The full-frame one-GPU step is printed beside it with a witness: the
    same step over 16 pixel chunks, summed in float64. A float32 reduction
    over the whole frame carries a rounding error the shorter chunked sums
    do not; the witness shows how much of the gap between dp4 and the
    full-frame step that error is.

    Render: colors agree but for the percentile of flipped paths the
    sharding tests allow (< 2% of pixels beyond 1e-4, median difference
    < 1e-6).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pbrjax.parallel.mesh import make_mesh, sharded_render, sharded_train_step

    devs = jax.devices()
    assert len(devs) >= 4, f"--four needs four GPUs, found {len(devs)}"
    scene, cam = load("cornell")
    s = settings_for(scene, SIZE)
    js, jc = to_dev(scene), to_dev(cam)
    npx = SIZE * SIZE
    target = np.full((npx, 3), 0.25, np.float32)
    mesh4 = make_mesh(n_dp=4, n_sp=1, devices=devs[:4])
    mesh1 = make_mesh(n_dp=1, n_sp=1, devices=devs[:1])
    log(f"  cornell {SIZE}² dispatch '{dispatch(scene)}'; mesh {dict(mesh4.shape)}")
    out, imgs = {}, {}
    for tag, mesh in (("dp4", mesh4), ("dp1", mesh1)):
        fn = lambda: sharded_train_step(mesh, js, jc, s, target, frame_seed=3)  # noqa: E731
        first, steady, (loss, grads, _) = timed(fn)
        report_time(f"sharded_train_step {tag}", first, steady)
        out[tag] = (float(loss), float_leaves(grads))
        fn = lambda: sharded_render(mesh, js, jc, s, 5)[0]  # noqa: E731
        first, steady, c = timed(fn)
        report_time(f"sharded_render {tag}", first, steady)
        imgs[tag] = np.stack([np.asarray(c.x), np.asarray(c.y), np.asarray(c.z)], -1)

    def chunked(k: int):
        """The one-GPU step over k contiguous pixel chunks: float64 sums of
        the losses, of the gradients and of the gradients' magnitudes."""
        n = npx // k
        loss, grads, mags = 0.0, None, None
        t0 = time.perf_counter()
        for c in range(k):
            sl = slice(c * n, (c + 1) * n)
            l, g, _ = sharded_train_step(mesh1, js, jc, s, target[sl], frame_seed=3,
                                         pixel_ids=jnp.arange(npx, dtype=jnp.int32)[sl])
            g = [a.astype(np.float64) for a in float_leaves(g)]
            loss += float(l)
            grads = g if grads is None else [x + y for x, y in zip(grads, g)]
            mags = ([np.abs(a) for a in g] if mags is None
                    else [m + np.abs(a) for m, a in zip(mags, g)])
        log(f"  one-GPU step over {k} chunks of {n} pixels: "
            f"{time.perf_counter() - t0:.2f} s with compile [{CARD}]")
        return loss, grads, mags

    (l4, g4), (l1, g1) = out["dp4"], out["dp1"]
    ls4, gs4, mags4 = chunked(4)
    ls16, gs16, _ = chunked(16)
    scale = max(float(np.abs(b).max()) for b in gs4)
    ulp = np.finfo(np.float32).eps
    tol = [2e-4 * np.abs(b) + 4 * ulp * m for b, m in zip(gs4, mags4)]
    worst = max(float((np.abs(a - b) / np.maximum(t, np.finfo(np.float64).tiny)).max())
                for a, b, t in zip(g4, gs4, tol))
    log(f"  train step dp4 vs the float64 sum of the one-GPU step over its four "
        f"shards: loss {l4:.7f} vs {ls4:.7f}, rel diff {abs(l4 - ls4) / ls4:.3e}; "
        f"{len(g4)} gradient leaves, worst at {worst:.3e} of the tolerance")
    log(f"  witness, against the float64 sum of the one-GPU step over 16 chunks "
        f"(loss {ls16:.7f}):")
    for tag, (loss, g) in (("dp4", (l4, g4)), ("dp1 full frame", (l1, g1)),
                           ("4 shards, float64", (ls4, gs4))):
        _, diff, (va, vb) = _leaf_diff(g, gs16)
        log(f"    {tag}: loss rel diff {abs(loss - ls16) / ls16:.3e}; largest "
            f"gradient diff {diff:.4g} ({va:.6g} vs {vb:.6g}) = "
            f"{diff / scale:.3e} of the largest entry {scale:.4g}")
    _, diff, (va, vb) = _leaf_diff(g4, g1)
    log(f"  dp4 vs dp1 full frame: loss rel diff {abs(l4 - l1) / abs(l1):.3e}; "
        f"largest gradient diff {diff:.4g} ({va:.6g} vs {vb:.6g})")
    d = np.abs(imgs["dp4"] - imgs["dp1"]).max(axis=-1)
    log(f"  render: {(d > 1e-4).mean():.4%} pixels beyond 1e-4, median diff "
        f"{np.median(d):.2e}, max diff {d.max():.2e}")
    np.testing.assert_allclose(l4, ls4, rtol=2e-5)
    assert worst <= 1.0, worst
    assert (d > 1e-4).mean() < 0.02 and np.median(d) < 1e-6


PHASES = [
    ("1 brute kernel vs intersect_brute", phase_kernel),
    ("2 cornell forward (PathTracer) + oracle", phase_cornell_forward),
    ("3 cornell fwd+bwd + GPU/CPU parity", phase_cornell_fwdbwd),
    ("4 BVH-walk scenes", phase_bvh_scenes),
    ("5 fit CLI", phase_fit),
]


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the dp=4 four-GPU phase")
    args = ap.parse_args()
    try:
        from pbrjax.utils.cache import enable_persistent_cache
    except ImportError as e:
        print(f"chip_smoke: the pbrjax package is not importable here ({e})",
              file=sys.stderr)
        return 2
    enable_persistent_cache()
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform} "
              f"({devs[0].device_kind}); no CPU fallback", file=sys.stderr)
        return 2
    from pbrjax.utils.profiling import gpu_card

    card = gpu_card()  # one line per GPU
    CARD = " | ".join(dict.fromkeys(card.splitlines()))  # inline tag: each kind once
    count = 4 if args.four else 1
    log(f"device: {devs[0].device_kind} x{len(devs)} (using {count}); card: {CARD}")
    failed = []
    for title, fn in [("6 dp=4 over four GPUs", phase_four)] if args.four else PHASES:
        log(f"[phase {title}]")
        t0 = time.perf_counter()
        try:
            fn(args)
            log(f"[phase {title}] ok in {time.perf_counter() - t0:.1f} s")
        except Exception:
            traceback.print_exc()
            log(f"[phase {title}] FAILED after {time.perf_counter() - t0:.1f} s")
            failed.append(title)
    log(card)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
