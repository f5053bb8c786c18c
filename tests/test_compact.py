"""Live-lane compaction (integrator compact_schedule) correctness.

Compaction is a pure permutation of the extension-phase lanes plus a
capacity policy; with enough capacity the image must be *bitwise* identical
to the full-width render, for both backends, because the RNG is
pixel-keyed (rng.gather) and every per-lane operation is unchanged.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

import jax
import jax.numpy as jnp

from pbrjax.models.integrator import trace_rays
from pbrjax.scene.build import scene_from_text
from pbrjax.scene.camera import make_camera_state
from pbrjax.scene.procedural import cornell_box
from pbrjax.utils.config import BRDF_SCHLICK, BRDF_SHIRLEY_ASHIKHMIN, RenderSettings


SIZE = 24


def _render(xp, scene, cam, settings):
    ids = xp.arange(SIZE * SIZE, dtype=xp.int32)
    if xp is jnp:
        fn = jax.jit(
            lambda sc, c, i: trace_rays(
                xp, sc, c, settings, i, 7, with_stats=True
            ),
            static_argnums=(),
        )
        res = fn(scene, cam, ids)
    else:
        res = trace_rays(xp, scene, cam, settings, ids, 7, with_stats=True)
    img = np.stack(
        [np.asarray(res.color.x), np.asarray(res.color.y), np.asarray(res.color.z)]
    )
    return img, res


@pytest.fixture(scope="module")
def cornell():
    obj, mtl, li = cornell_box()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=False)
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    return scene, cam


@pytest.mark.parametrize("brdf", [BRDF_SCHLICK, BRDF_SHIRLEY_ASHIKHMIN])
@pytest.mark.parametrize("loop", ["scan", "unroll"])
def test_compact_bitwise_identical_jax(cornell, brdf, loop):
    scene, cam = cornell
    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    jcam = jax.tree_util.tree_map(jnp.asarray, cam)
    base = RenderSettings(
        width=SIZE, height=SIZE, samples=1, max_depth=3, max_added_depth=5,
        shadow_rays=1, anti_aliasing=0.7, brdf=brdf, bounce_loop=loop,
        sky_light=(0.8, 0.9, 1.0),
    )
    img_full, _ = _render(jnp, jscene, jcam, base)
    img_cmp, res = _render(
        jnp,
        jscene,
        jcam,
        base.replace(compact_schedule=((3, 0.5), (4, 0.25)), compact_block=1),
    )
    assert int(res.n_dropped) == 0
    # The permutation itself is exact — proven bitwise on the numpy path
    # below (test_compact_bitwise_identical_numpy) where every op runs
    # eagerly. Under jit the full-width and compacted programs are
    # *different XLA programs*, and the backend forms FMAs / fuses
    # per-program, so a handful of lanes can differ by float32 ulps.
    np.testing.assert_allclose(img_cmp, img_full, rtol=1e-6, atol=1e-6)


def test_compact_rows_bitwise_identical_jax(cornell):
    """Row-granular compaction (compact_block > 1) keeps whole rows of
    lanes; with row capacity above the live-row count the image matches
    full width (ulp gate — see the lane-granular test above for why jit
    programs are compared at float32-ulp rather than bitwise)."""
    scene, cam = cornell
    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    jcam = jax.tree_util.tree_map(jnp.asarray, cam)
    base = RenderSettings(
        width=SIZE, height=SIZE, samples=1, max_depth=3, max_added_depth=5,
        shadow_rays=1, anti_aliasing=0.7, brdf=BRDF_SCHLICK,
        sky_light=(0.8, 0.9, 1.0),
    )
    img_full, _ = _render(jnp, jscene, jcam, base)
    # 576 lanes / block 8 = 72 rows; fracs sized so no live row overflows.
    img_cmp, res = _render(
        jnp,
        jscene,
        jcam,
        base.replace(compact_schedule=((3, 0.75), (4, 0.5)), compact_block=8),
    )
    assert int(res.n_dropped) == 0
    np.testing.assert_allclose(img_cmp, img_full, rtol=1e-6, atol=1e-6)


def test_compact_bitwise_identical_numpy(cornell):
    scene, cam = cornell
    base = RenderSettings(
        width=SIZE, height=SIZE, samples=2, max_depth=3, max_added_depth=5,
        shadow_rays=1, anti_aliasing=0.7, brdf=BRDF_SCHLICK,
        sky_light=(0.8, 0.9, 1.0),
    )
    img_full, _ = _render(np, scene, cam, base)
    img_cmp, res = _render(
        np, scene, cam, base.replace(compact_schedule=((3, 0.5), (4, 0.25)), compact_block=1)
    )
    assert int(res.n_dropped) == 0
    np.testing.assert_array_equal(img_cmp, img_full)


def test_compact_overflow_drops_counted(cornell):
    """With a capacity far below the live count, overflow lanes terminate
    early: the render stays finite and the drop counter reports them."""
    scene, cam = cornell
    settings = RenderSettings(
        width=SIZE, height=SIZE, samples=1, max_depth=3, max_added_depth=5,
        shadow_rays=1, brdf=BRDF_SCHLICK, sky_light=(0.8, 0.9, 1.0),
        # compact at bounce 1, where nearly the whole batch is alive.
        compact_schedule=((1, 0.25),),
    )
    img, res = _render(np, scene, cam, settings)
    assert np.all(np.isfinite(img))
    assert int(res.n_dropped) > 0


def test_overflow_warning_and_golden_gate(cornell):
    """VERDICT r4 item 5: an overflowing schedule fires the PathTracer
    warning (without --stats) and the image still matches the full-width
    render within the golden gate (drops bias only deep-extension lanes)."""
    import io

    from pbrjax.models.pathtracer import PathTracer
    from pbrjax.utils.log import Logger

    scene, cam = cornell
    base = RenderSettings(
        width=SIZE, height=SIZE, samples=1, max_depth=3, max_added_depth=5,
        shadow_rays=1, brdf=BRDF_SCHLICK, sky_light=(0.8, 0.9, 1.0),
        bounce_loop="scan", sample_loop="scan", compact_block=1,
    )
    pt_full = PathTracer(scene, base, donate=False)
    pt_full.render(cam, frame_seed=3)
    img_full = pt_full.image()

    # Caps slightly under the true occupancy (46 live rows at bounce 2 on
    # this scene/seed; cap 0.07*576 = 41) -> a few drops.
    tight = base.replace(compact_schedule=((2, 0.07),))
    stream, old = io.StringIO(), Logger.stream
    Logger.stream = stream
    try:
        pt = PathTracer(scene, tight, donate=False)
        pt.render(cam, frame_seed=3)
        img = pt.image()
    finally:
        Logger.stream = old
    assert "compaction capacity overflow" in stream.getvalue()
    # Only a handful of lanes lose their deep bounces: the image stays
    # within the percentile golden gate used by the device goldens.
    diff = np.abs(img - img_full)
    assert np.mean(diff < 1e-3) > 0.95
    assert np.mean(diff) < 2e-3


def test_auto_compact_schedule_probe(cornell):
    """compact_schedule='auto' derives caps from the occupancy probe; the
    derived schedule renders with zero drops."""
    from pbrjax.models.pathtracer import PathTracer, probe_compact_schedule

    scene, cam = cornell
    base = RenderSettings(
        width=SIZE, height=SIZE, samples=1, max_depth=3, max_added_depth=5,
        shadow_rays=1, brdf=BRDF_SCHLICK, sky_light=(0.8, 0.9, 1.0),
        bounce_loop="scan", sample_loop="scan", compact_block=1,
    )
    import jax
    import jax.numpy as jnp

    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    sched = probe_compact_schedule(jscene, cam, base, max_leaf=2)
    assert all(0 < f <= 1.0 for _, f in sched)
    assert [kb for kb, _ in sched] == sorted({kb for kb, _ in sched})

    pt = PathTracer(
        scene, base.replace(compact_schedule="auto"), donate=False,
        lane_order="scanline",
    )
    pt.render(cam, frame_seed=3)
    assert pt.settings.compact_schedule == sched
    # The derived caps must not drop lanes on the scene they were probed on.
    res = trace_rays(
        np, scene, cam, base.replace(compact_schedule=sched),
        np.arange(SIZE * SIZE, dtype=np.int32), 3, with_stats=True,
    )
    assert res.n_dropped is None or int(res.n_dropped) == 0
