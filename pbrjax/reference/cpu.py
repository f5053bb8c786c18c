"""CPU oracle tracer: the NumPy instantiation of the integrator.

This is the "CPU reference path tracer" the correctness gate compares
against (BASELINE.json: "pixel-grad allclose vs reference"). It runs the
*same* backend-generic integrator with ``xp = numpy`` — same math, same
counter-based RNG — so the device render must match it to float tolerance.
An additional, fully independent scalar implementation lives in
``pbrjax.reference.scalar`` and cross-checks the integrator logic itself
on tiny crops.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pbrjax.models.integrator import trace_rays
from pbrjax.scene.types import CameraState, Scene
from pbrjax.utils.config import RenderSettings


def render_cpu(
    scene: Scene,
    cam: CameraState,
    settings: RenderSettings,
    frame_seed: int = 0,
    prev_t: Optional[np.ndarray] = None,
    chunk: int = 65536,
    max_leaf: int = 2,
) -> tuple:
    """Render one frame on CPU. Returns ``(rgb (H,W,3), focus_t (H,W))``.

    Renders in pixel chunks to bound the NumPy working set (the oracle runs
    at test resolutions; it is not a performance path).
    """
    w, h = settings.width, settings.height
    npx = w * h
    rgb = np.zeros((npx, 3), dtype=np.float32)
    focus = np.zeros((npx,), dtype=np.float32)
    prev_flat = None if prev_t is None else np.asarray(prev_t, dtype=np.float32).reshape(-1)
    with np.errstate(all="ignore"):
        for start in range(0, npx, chunk):
            ids = np.arange(start, min(start + chunk, npx), dtype=np.int32)
            res = trace_rays(
                np,
                scene,
                cam,
                settings,
                ids,
                frame_seed,
                prev_t=None if prev_flat is None else prev_flat[ids],
                max_leaf=max_leaf,
            )
            rgb[ids, 0] = res.color.x
            rgb[ids, 1] = res.color.y
            rgb[ids, 2] = res.color.z
            focus[ids] = res.focus_t
    return rgb.reshape(h, w, 3), focus.reshape(h, w)
