"""Benchmark: rays/s per GPU, forward+backward, 1spp 1024x1024 Cornell box.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N}

Metric definition (BASELINE.json): a full differentiable frame — render the
Cornell scene at 1024x1024, 1 sample/pixel, reference-default depth limits
(max_depth 3 + up to 5 extensions, config.json:99-101), NEE shadow rays on —
plus the backward pass producing gradients w.r.t. materials, lights, and
camera. rays/s counts *actual traced rays* (live path segments + shadow
rays, measured by the integrator's work counters, not an optimistic
width*height*depth product). vs_baseline is against the 200M rays/s/chip
target (the reference publishes no numbers — BASELINE.md).

Runs on the GPU and refuses any other backend (``--scaling`` aside, which
measures sharding overhead on a virtual CPU mesh). Prints the device and
the card's power limit first. Use --quick for a smaller sanity config,
--fwd-only to benchmark rendering without gradients.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--quick", action="store_true", help="256x256 sanity run")
    ap.add_argument("--fwd-only", action="store_true")
    ap.add_argument("--iters", type=int, default=5)
    # Frames per jit call (a lax.scan over frame seeds).
    ap.add_argument("--frames-per-step", type=int, default=1, dest="frames_per_step")
    ap.add_argument("--bvh", action="store_true", help="force BVH intersector")
    ap.add_argument(
        "--scene",
        default="cornell",
        help="'cornell' (default, the BASELINE metric), 'multiroom', "
        "'soup:N' — N random triangles under an orb light (milestone "
        "config 5's geometry leg; always BVH-accelerated) — or an .obj path",
    )
    ap.add_argument(
        "--intersector",
        default=None,
        choices=["brute", "bvh", "pallas"],
        help="override the intersector dispatch (default: auto)",
    )
    ap.add_argument(
        "--no-compact",
        action="store_true",
        help="disable live-lane compaction of the extension bounces",
    )
    ap.add_argument(
        "--compact",
        # Default: the occupancy probe derives the schedule per scene.
        default=None,
        help="compaction schedule bounce:frac[,bounce:frac...] (row fracs)",
    )
    ap.add_argument(
        "--block", type=int, default=128, help="compaction row granularity (lanes)"
    )
    ap.add_argument(
        "--bounce-loop",
        default=None,
        choices=["unroll", "scan"],
        dest="bounce_loop",
        help="bounce-loop strategy override (default: unroll — production "
        "runtime; big-scene configs may prefer scan's flat compile time)",
    )
    ap.add_argument(
        "--remat",
        default="none",
        choices=["none", "save_isect"],
        help="backward-pass rematerialization policy",
    )
    ap.add_argument(
        "--lane-order",
        default="auto",
        choices=["auto", "scanline", "morton"],
        dest="lane_order",
        help="pixel->lane mapping: 'morton' makes compaction blocks and "
        "cull groups square pixel patches (utils/morton.py) — wins on "
        "object-against-sky scenes; 'auto' = morton for non-cornell",
    )
    ap.add_argument(
        "--scaling",
        action="store_true",
        help="dp-scaling harness on the virtual 8-device CPU mesh: rays/s "
        "at dp=1/2/4/8 + parallel efficiency (methodology for the >=85% "
        "multi-host gate; virtual devices share host cores, so this "
        "measures sharding/collective overhead, not real chip speedup)",
    )
    args = ap.parse_args()

    if args.scaling:
        return run_scaling(args)

    from pbrjax.utils.cache import enable_persistent_cache

    # Persistent XLA cache: repeat runs of the same config skip the
    # multi-ten-second compile (the cold number is still reported by the
    # first run; PBRJAX_NO_CACHE=1 to force cold).
    enable_persistent_cache()
    import jax
    import jax.numpy as jnp

    from pbrjax.utils.profiling import gpu_card

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"[bench] needs a GPU; JAX found {dev.platform} ({dev.device_kind})")
    print(f"[bench] device: {dev.device_kind} x{len(jax.devices())}; card: "
          f"{gpu_card()}", file=sys.stderr)

    from pbrjax.models.integrator import trace_rays
    from pbrjax.scene.build import scene_from_text
    from pbrjax.scene.camera import make_camera_state
    from pbrjax.scene.procedural import named_scene
    from pbrjax.utils.config import RenderSettings

    size = 256 if args.quick else args.size
    sky_override = (0.85, 0.9, 1.0)
    shadow_override = 1
    if args.scene.endswith(".obj"):
        import os

        from pbrjax.io.loader import load_model

        if not os.path.isfile(args.scene):
            print(f"[bench] scene not found: {args.scene}", file=sys.stderr)
            sys.exit(2)
        # load_model needs shadow_rays>0 to pick up the .lights companion;
        # scenes with no .lights flip it back off (LightParser.cpp:116-121
        # semantics), which shadow_override propagates below.
        scene, lset, _ = load_model(args.scene, RenderSettings(shadow_rays=1))
        sky_override = lset.sky_light
        shadow_override = lset.shadow_rays
        # Reference default camera (config.json camera.eye/center).
        cam = make_camera_state(eye=(0.0, 1.0, 3.0), center_dir=(0.0, 0.0, 1.0))
        scene_tag = os.path.splitext(os.path.basename(args.scene))[0]
    else:
        obj, mtl, li, eye = named_scene(args.scene)
        t_build = time.time()
        # Cornell builds no BVH unless --bvh (the brute sweep serves it).
        use_bvh = args.bvh or args.scene != "cornell"
        scene, _ = scene_from_text(obj, mtl, li, use_bvh=use_bvh)
        if use_bvh:
            print(
                f"[bench] {args.scene}: BVH of {scene.bvh.count} nodes built in "
                f"{time.time() - t_build:.2f}s",
                file=sys.stderr,
            )
        cam = make_camera_state(eye=eye, center_dir=(0.0, 0.0, 1.0))
        scene_tag = args.scene.replace(":", "")
    settings = RenderSettings(
        width=size,
        height=size,
        samples=1,
        max_depth=3,
        max_added_depth=5,
        shadow_rays=shadow_override,
        anti_aliasing=0.7,
        sky_light=sky_override,
        bounce_loop=args.bounce_loop or "unroll",
        # Row-granular live compaction (rows of --block consecutive
        # lanes); without --compact the occupancy probe below derives the
        # schedule. Exact (tests/test_compact.py) as long as no lane drops.
        compact_schedule=()
        if args.no_compact
        else tuple(
            (int(p.split(":")[0]), float(p.split(":")[1]))
            for p in (args.compact or "4:0.95,5:0.3").split(",")
        ),
        compact_block=args.block,
        remat=args.remat,
        **({"intersector": args.intersector} if args.intersector else {}),
    )

    from pbrjax.scene.build import bvh_max_leaf, derive_static_flags

    # Static traversal bound: big scenes build coarser BVH leaves
    # (scene/build.py LARGE_SCENE_LEAF).
    max_leaf = bvh_max_leaf(scene)
    # Opaque-only scenes statically skip the refraction chain (bitwise-
    # identical output; scene/build.py::derive_static_flags).
    settings = derive_static_flags(scene, settings)

    lane_order = args.lane_order
    if lane_order == "auto":
        lane_order = "scanline" if scene_tag == "cornell" else "morton"

    # Probe on EVERY scene: a probe-derived schedule can never be stale
    # against the scene or the lane order in effect (ADVICE r4).
    if args.compact is None and not args.no_compact:
        # Non-Cornell scenes: derive the schedule from the occupancy probe
        # (probe_compact_schedule) instead of a per-scene constant — on
        # miss-heavy scenes most primary rays die at bounce 0 and the
        # probe discovers early-bounce caps a fixed schedule can't know.
        from pbrjax.models.pathtracer import probe_compact_schedule

        t_probe = time.time()
        probe_ids = None
        if lane_order == "morton":
            from pbrjax.utils.morton import morton_pixel_ids

            probe_ids = morton_pixel_ids(size, size)
        sched = probe_compact_schedule(
            scene, cam, settings, max_leaf=max_leaf, pixel_ids=probe_ids
        )
        settings = settings.replace(compact_schedule=sched)
        print(
            f"[bench] probed compaction schedule {sched} in "
            f"{time.time() - t_probe:.1f}s",
            file=sys.stderr,
        )

    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    jcam = jax.tree_util.tree_map(jnp.asarray, cam)
    npx = size * size
    if lane_order == "morton":
        from pbrjax.utils.morton import morton_pixel_ids

        ids = jnp.asarray(morton_pixel_ids(size, size))
        print("[bench] lane order: morton (16x8-pixel blocks)", file=sys.stderr)
    else:
        ids = jnp.arange(npx, dtype=jnp.int32)

    # ---- measure actual ray counts (one instrumented trace) --------------
    @functools.partial(jax.jit, static_argnames=("settings",))
    def count_fn(scene, cam, ids, seed, settings):
        res = trace_rays(
            jnp, scene, cam, settings, ids, seed, max_leaf=max_leaf,
            with_stats=True,
        )
        return res.n_path_rays, res.n_shadow_rays, res.n_dropped

    # The compacted counters count exactly the live lanes the full-width
    # estimator would (tests/test_compact.py) as long as nothing drops —
    # verified by n_dropped here.
    n_path, n_shadow, n_drop = count_fn(jscene, jcam, ids, jnp.uint32(0), settings)
    rays_per_frame = int(n_path) + int(n_shadow)
    # Row-live occupancy is seed-dependent; make sure the compaction caps
    # clear it for more than the counting seed (drops would silently bias
    # the estimator, so the caps carry headroom — see --compact default).
    # n_drop is None when no schedule is active (e.g. the probe found
    # full occupancy on an interior scene and returned no caps).
    n_drop_max = int(n_drop) if n_drop is not None else 0
    if settings.compact_schedule:
        for seed in (1, 2, 3):
            _, _, nd = count_fn(jscene, jcam, ids, jnp.uint32(seed), settings)
            n_drop_max = max(n_drop_max, int(nd))
        n_drop = n_drop_max
    print(
        f"[bench] {size}x{size}: {int(n_path)} path segments + "
        f"{int(n_shadow)} shadow rays = {rays_per_frame} rays/frame",
        file=sys.stderr,
    )
    if settings.compact_schedule:
        print(f"[bench] compaction drops: {int(n_drop)} lanes", file=sys.stderr)
        if int(n_drop) > 0:
            print(
                "[bench] WARNING: capacity overflow — raise --compact fracs",
                file=sys.stderr,
            )

    # ---- the timed step ---------------------------------------------------
    # K frames per jit call via lax.scan (--frames-per-step).
    K = args.frames_per_step
    from pbrjax.ops import rng as rng_mod

    if args.fwd_only:

        @functools.partial(jax.jit, static_argnames=("settings",))
        def step(scene, cam, ids, seed0, settings):
            def body(acc, k):
                seed = rng_mod.fold(seed0, k)
                res = trace_rays(jnp, scene, cam, settings, ids, seed, max_leaf=max_leaf)
                return acc + res.color.x.sum() + res.color.y.sum() + res.color.z.sum(), None

            acc, _ = jax.lax.scan(body, jnp.float32(0.0), jnp.arange(K, dtype=jnp.uint32))
            return acc

    else:

        @functools.partial(jax.jit, static_argnames=("settings",))
        def step(scene, cam, ids, seed0, settings):
            params0 = (scene.materials, scene.lights, cam)

            def frame_loss(params, seed):
                mats, lights, camst = params
                sc = scene._replace(materials=mats, lights=lights)
                res = trace_rays(jnp, sc, camst, settings, ids, seed, max_leaf=max_leaf)
                return res.color.x.sum() + res.color.y.sum() + res.color.z.sum()

            def body(carry, k):
                loss_sum, gsum = carry
                seed = rng_mod.fold(seed0, k)
                loss, grads = jax.value_and_grad(frame_loss, allow_int=True)(
                    params0, seed
                )
                gsum = jax.tree_util.tree_map(
                    lambda a, b: a if b.dtype == jax.dtypes.float0 else a + b,
                    gsum,
                    grads,
                )
                return (loss_sum + loss, gsum), None

            gzero = jax.tree_util.tree_map(
                lambda p: jnp.zeros_like(p)
                if jnp.issubdtype(p.dtype, jnp.floating)
                else jnp.zeros_like(p),
                params0,
            )
            (loss, gsum), _ = jax.lax.scan(
                body, (jnp.float32(0.0), gzero), jnp.arange(K, dtype=jnp.uint32)
            )
            return loss, gsum[0].kd.x, gsum[1].rgb.x, gsum[2].eye.x

    t0 = time.time()
    jax.block_until_ready(step(jscene, jcam, ids, jnp.uint32(1), settings))
    compile_s = time.time() - t0
    print(f"[bench] compile+first step: {compile_s:.1f}s", file=sys.stderr)

    iters = args.iters
    t0 = time.time()
    for i in range(iters):
        out = step(jscene, jcam, ids, jnp.uint32(i + 2), settings)
    jax.block_until_ready(out)
    dt = (time.time() - t0) / (iters * K)
    rays_per_s = rays_per_frame / dt
    print(
        f"[bench] {dt * 1e3:.2f} ms/step -> {rays_per_s / 1e6:.1f} M rays/s "
        f"({'fwd' if args.fwd_only else 'fwd+bwd'})",
        file=sys.stderr,
    )

    mode = "fwd" if args.fwd_only else "fwd+bwd"
    print(
        json.dumps(
            {
                "metric": f"rays/s/GPU ({mode}) 1spp {size}x{size} {scene_tag}",
                "value": round(rays_per_s, 1),
                "unit": "rays/s",
                "vs_baseline": round(rays_per_s / 200e6, 4),
            }
        )
    )


def run_scaling(args) -> None:
    """dp-scaling harness (BASELINE.md ≥85% multi-host efficiency gate).

    Runs the SAME sharded render (parallel/mesh.py::sharded_render — the
    production multi-chip path incl. the multihost pixel-id assembly) at
    dp = 1/2/4/8 on a virtual 8-device CPU mesh and reports parallel
    efficiency T1/(N·TN). On real hardware the identical code path shards
    over pods (jax.distributed + global_mesh); these numbers validate that
    the choreography adds no per-shard overhead — virtual devices share the
    host's cores, so wall-clock speedup itself is bounded by core count.
    """
    import json
    import os
    import sys
    import time

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from pbrjax.models.integrator import trace_rays
    from pbrjax.parallel.mesh import make_mesh, sharded_render
    from pbrjax.scene.build import scene_from_text
    from pbrjax.scene.camera import make_camera_state
    from pbrjax.scene.procedural import cornell_box
    from pbrjax.utils.config import RenderSettings

    size = 128 if args.quick else 256
    obj, mtl, li = cornell_box()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=False)
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    settings = RenderSettings(
        width=size, height=size, samples=1, max_depth=3, max_added_depth=2,
        shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0),
        bounce_loop="scan",
    )
    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    jcam = jax.tree_util.tree_map(jnp.asarray, cam)

    # Actual ray count (work is dp-invariant: same image, same rays).
    res = trace_rays(
        jnp, jscene, jcam, settings,
        jnp.arange(size * size, dtype=jnp.int32), jnp.uint32(0), with_stats=True,
    )
    rays = int(res.n_path_rays) + int(res.n_shadow_rays)

    def cpu_busy():
        # Host CPU busy fraction from /proc/stat (user+nice+sys vs total).
        with open("/proc/stat") as f:
            parts = f.readline().split()[1:]
        vals = [int(v) for v in parts[:8]]
        busy = vals[0] + vals[1] + vals[2] + vals[5] + vals[6]
        return busy, sum(vals)

    iters = max(2, args.iters)
    table = {}
    for n_dp in (1, 2, 4, 8):
        mesh = make_mesh(n_dp=n_dp, n_sp=1)
        c, _ = sharded_render(mesh, jscene, jcam, settings, 1)  # compile
        np.asarray(c.x)
        b0, t0c = cpu_busy()
        t0 = time.time()
        for i in range(iters):
            c, _ = sharded_render(mesh, jscene, jcam, settings, i + 2)
        np.asarray(c.x)
        dt = (time.time() - t0) / iters
        b1, t1c = cpu_busy()
        util = (b1 - b0) / max(1, t1c - t0c)
        table[n_dp] = dt
        # Virtual devices share the host's cores: total work is constant,
        # so the observable is the choreography OVERHEAD factor T1/TN
        # (1.0 = sharding adds nothing; on N real chips per-chip work is
        # 1/N, making T1/TN the expected parallel efficiency). Host CPU
        # utilization attributes the gap: if dp=1 already saturates the
        # cores, a T1/TN < 1 is executor oversubscription (contention),
        # not sharding choreography.
        eff = table[1] / dt
        print(
            f"[scaling] dp={n_dp}: {dt * 1e3:8.1f} ms/frame  "
            f"{rays / dt / 1e6:7.2f} M rays/s  overhead-eff {eff:.2f}  "
            f"host-cpu {util:5.1%}",
            file=sys.stderr,
        )

    # Per-shard isolation control: ONE dp=8-sized shard (1/8 of the rows)
    # rendered alone on a 1-device mesh — the contention-free per-shard
    # time. 8 x this, overlapped perfectly, would be the ideal T8; the
    # measured T8 above exceeding it quantifies executor contention +
    # choreography, and the dp=8 host-cpu row says which.
    shard_h = size // 8
    solo_set = settings.replace(height=shard_h)
    mesh1 = make_mesh(n_dp=1, n_sp=1)
    c, _ = sharded_render(mesh1, jscene, jcam, solo_set, 1)
    np.asarray(c.x)
    t0 = time.time()
    for i in range(iters):
        c, _ = sharded_render(mesh1, jscene, jcam, solo_set, i + 2)
    np.asarray(c.x)
    dt_solo = (time.time() - t0) / iters
    print(
        f"[scaling] solo 1/8 shard ({size}x{shard_h}): {dt_solo * 1e3:8.1f} "
        f"ms/frame -> ideal-overlap T8 {dt_solo * 1e3:8.1f} ms vs measured "
        f"{table[8] * 1e3:8.1f} ms (x{table[8] / dt_solo:.2f})",
        file=sys.stderr,
    )

    eff8 = table[1] / table[8]
    print(
        json.dumps(
            {
                "metric": f"dp-sharding overhead efficiency T1/T8 (virtual 8-dev CPU mesh, {size}x{size})",
                "value": round(eff8, 4),
                "unit": "ratio",
                "vs_baseline": round(eff8 / 0.85, 4),
            }
        )
    )


if __name__ == "__main__":
    main()
