"""Fused brute-force intersect kernel (ops/pallas_intersect.py) on the CPU.

The kernel is compiled through Triton for the GPU; here ``interpret=True``
runs the same kernel body through the Pallas interpreter, and the CUDA
lowering (Pallas -> Triton IR) is checked without a card. Ground truth is
the XLA sweep (``intersect_brute``) and the integrator's separate-shadow
formulation.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pbrjax.ops import pallas_intersect
from pbrjax.ops.intersect import INF
from pbrjax.ops.pallas_intersect import BLOCK, face_table, intersect_pallas
from pbrjax.ops.traverse import intersect_brute
from pbrjax.ops.vec import Vec3, safe_div, safe_sqrt
from pbrjax.scene.build import scene_from_text
from pbrjax.scene.procedural import cornell_box, random_soup

LIGHT = Vec3(jnp.float32(0.0), jnp.float32(1.8), jnp.float32(0.2))


@functools.lru_cache(maxsize=None)
def _scene(name):
    if name == "cornell":
        obj, mtl, li = cornell_box()
        scene, _ = scene_from_text(obj, mtl, li, use_bvh=False)
    else:
        scene, _ = scene_from_text(random_soup(48, seed=2), use_bvh=False)
    return jax.tree_util.tree_map(jnp.asarray, scene)


def _rays(n, seed=3):
    rng = np.random.default_rng(seed)
    # Origins inside the box, directions on the sphere.
    o = Vec3(*[jnp.asarray(rng.uniform(-0.8, 0.8, n), jnp.float32) for _ in range(3)])
    dn = rng.normal(size=(3, n)).astype(np.float32)
    dn /= np.linalg.norm(dn, axis=0, keepdims=True)
    return o, Vec3(*[jnp.asarray(c) for c in dn])


def _shadow_ref(tris, o, d, t):
    """The integrator's separate-shadow math on the kernel's t."""
    hit = jnp.isfinite(t)
    ts = jnp.where(hit, t, jnp.float32(1.0))
    hit_p = o + d * ts
    ones = jnp.ones_like(o.x)
    l_vec = Vec3(LIGHT.x * ones, LIGHT.y * ones, LIGHT.z * ones) - hit_p
    t_light = safe_sqrt(l_vec.length2())
    l_dir = l_vec * safe_div(jnp.float32(1.0), t_light)
    t_sh, _ = intersect_brute(jnp, hit_p, l_dir, tris)
    return np.asarray((t_sh < t_light) & hit)


@pytest.mark.parametrize("alive_mask", [False, True], ids=["all-alive", "masked"])
@pytest.mark.parametrize("n", [1, BLOCK - 1, 2 * BLOCK + 37])
@pytest.mark.parametrize("nee", [False, True], ids=["nearest", "nee"])
@pytest.mark.parametrize("scene_name", ["cornell", "soup"])
def test_kernel_matches_brute(scene_name, nee, n, alive_mask):
    """Same expressions as the XLA sweep: the winning face and t match
    bitwise on live lanes; dead lanes report a miss and no occlusion; the
    fused shadow leg agrees with the separate shadow sweep."""
    js = _scene(scene_name)
    o, d = _rays(n, seed=n)
    alive = None
    live = np.ones(n, bool)
    if alive_mask:
        live = np.random.default_rng(n).uniform(size=n) > 0.4
        alive = jnp.asarray(live)
    out = intersect_pallas(
        jnp, o, d, js.tris, light_pos=LIGHT if nee else None, alive=alive,
        interpret=True,
    )
    t_b, f_b = (np.asarray(a) for a in intersect_brute(jnp, o, d, js.tris))
    t_p, f_p = np.asarray(out[0]), np.asarray(out[1])
    assert t_p.shape == f_p.shape == (n,)
    np.testing.assert_array_equal(f_p[live], f_b[live])
    np.testing.assert_array_equal(t_p[live], t_b[live])
    assert (f_p[~live] == -1).all() and (t_p[~live] == INF).all()
    if nee:
        occ = np.asarray(out[2])
        occ_ref = _shadow_ref(js.tris, o, d, out[0])
        np.testing.assert_array_equal(occ[live], occ_ref[live])
        assert not occ[~live].any()


def test_kernel_miss_is_inf():
    js = _scene("cornell")
    o, d = _rays(64)
    # Rays outside the box, facing away from it.
    far = Vec3(o.x + 100.0, o.y + 100.0, o.z + 100.0)
    up = Vec3(jnp.zeros_like(o.x), jnp.ones_like(o.x), jnp.zeros_like(o.x))
    t, f = intersect_pallas(jnp, far, up, js.tris, interpret=True)
    assert np.all(np.asarray(t) == INF)
    assert np.all(np.asarray(f) == -1)


def test_face_table_layout():
    """(16, next pow2 of F) with v0/e1/e2 rows and zero padding (padding
    faces have det = 0 and can never win)."""
    js = _scene("cornell")  # 34 faces -> 64 columns
    tab = np.asarray(face_table(js.tris))
    assert tab.shape == (16, 64)
    np.testing.assert_array_equal(tab[0, :34], np.asarray(js.tris.v0.x))
    np.testing.assert_array_equal(tab[8, :34], np.asarray(js.tris.e2.z))
    assert not tab[:, 34:].any() and not tab[9:].any()


@pytest.mark.parametrize("nee", [False, True], ids=["nearest", "nee"])
def test_kernel_lowers_to_triton_for_cuda(nee):
    """The Pallas -> Triton lowering for the CUDA platform runs without a
    card (only Triton -> PTX needs one): the kernel is one Triton custom
    call with the program count the ray batch asks for."""
    from jax import export

    js = _scene("cornell")
    o, d = _rays(3 * BLOCK)

    def f(o, d, tris):
        return intersect_pallas(jnp, o, d, tris, light_pos=LIGHT if nee else None)

    exp = export.export(
        jax.jit(f), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")],
    )(o, d, js.tris)
    text = exp.mlir_module()
    assert text.count("__gpu$xla.gpu.triton") == 1
    assert "grid_x = 3" in text


def test_kernel_composes_with_shard_map():
    """The kernel runs inside shard_map with the face table replicated and
    the rays dp-sharded, and agrees with the unsharded call. check_vma is
    off because the Pallas interpreter computes block offsets from
    unvarying grid indices; the compiled kernel runs under the checker in
    ``chip_smoke.py --four``."""
    from jax.sharding import PartitionSpec as P

    from pbrjax.parallel.mesh import make_mesh

    js = _scene("cornell")
    o, d = _rays(4 * BLOCK)
    mesh = make_mesh(n_dp=4, n_sp=1)
    f = jax.shard_map(
        lambda tris, ox, oy, oz, dx, dy, dz: intersect_pallas(
            jnp, Vec3(ox, oy, oz), Vec3(dx, dy, dz), tris, light_pos=LIGHT,
            interpret=True,
        ),
        mesh=mesh,
        in_specs=(P(),) + (P("dp"),) * 6,
        out_specs=(P("dp"),) * 3,
        check_vma=False,
    )
    got = f(js.tris, o.x, o.y, o.z, d.x, d.y, d.z)
    want = intersect_pallas(jnp, o, d, js.tris, light_pos=LIGHT, interpret=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("shadow_rays", [0, 1], ids=["nee-off", "nee-on"])
def test_kernel_tests_channel(shadow_rays, monkeypatch):
    """End to end through trace_rays with intersector='pallas': the kernel
    tests every face per live lane and bounce, and again for the fused
    shadow leg, so sum(heat_tests) == F * n_path (2F with NEE)."""
    from pbrjax.models.integrator import trace_rays
    from pbrjax.scene.camera import make_camera_state
    from pbrjax.utils.config import RenderSettings

    monkeypatch.setattr(
        pallas_intersect, "intersect_pallas",
        functools.partial(intersect_pallas, interpret=True),
    )
    js = _scene("cornell")
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    size = 8
    settings = RenderSettings(
        width=size, height=size, samples=1, max_depth=2, max_added_depth=1,
        shadow_rays=shadow_rays, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0),
        intersector="pallas",
    )
    res = trace_rays(
        jnp, js, jax.tree_util.tree_map(jnp.asarray, cam), settings,
        jnp.arange(size * size, dtype=jnp.int32), jnp.uint32(3), with_stats=True,
    )
    nf = js.tris.count
    n_path = int(res.n_path_rays)
    assert n_path > 0
    assert int(np.asarray(res.heat_tests).sum()) == nf * (1 + shadow_rays) * n_path
    assert int(np.asarray(res.heat_visits).sum()) == 0
