"""Shared test fixtures/helpers."""

from __future__ import annotations

import numpy as np

from pbrjax.scene.build import scene_from_text
from pbrjax.scene.camera import make_camera_state
from pbrjax.scene.procedural import cornell_box, single_triangle
from pbrjax.utils.config import RenderSettings


def tri_scene(use_bvh: bool = False):
    obj, mtl, li = single_triangle()
    scene, objdata = scene_from_text(obj, mtl, li, use_bvh=use_bvh)
    cam = make_camera_state(eye=(0.0, 0.5, 2.0), center_dir=(0.0, 0.0, 1.0))
    settings = RenderSettings(
        width=64, height=64, samples=1, max_depth=2, max_added_depth=0,
        shadow_rays=0, anti_aliasing=0.0,
    )
    return scene, cam, settings


def cornell_scene(use_bvh: bool = True, width: int = 64, height: int = 64, **kw):
    obj, mtl, li = cornell_box()
    scene, objdata = scene_from_text(obj, mtl, li, use_bvh=use_bvh)
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    defaults = dict(
        width=width, height=height, samples=1, max_depth=3, max_added_depth=2,
        shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0),
    )
    defaults.update(kw)
    settings = RenderSettings(**defaults)
    return scene, cam, settings


def to_jax(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(jnp.asarray, tree)
