"""Device-mesh parallelism: ray-tile DP × sample SP sharding, grad psum.

The reference was single-process single-GPU: one work-item per pixel, scene
replicated to the one device, and the only "communication" a blocking PCIe
copy per frame (SURVEY.md §2.5). The scaling story here replaces that with
a 2-D ``jax.sharding.Mesh``:

- **dp** — data parallelism over ray/pixel tiles: the image's pixel batch is
  sharded; each chip traces its own tile. This is the generalization of the
  reference's per-pixel NDRange (CL.cpp:289-306).
- **sp** — sample parallelism: independent Monte-Carlo frame estimates per
  shard (distinct RNG seeds), averaged with a ``psum`` across devices. Semantics
  equal progressive accumulation of ``sp`` frames (PathTracer.cpp:44), so
  sharded and unsharded renders agree to float tolerance.

Scene/material/light/camera arrays are replicated (the "broadcast" leg);
parameter gradients are ``psum``-reduced over both axes (the "all-reduce"
leg) — structurally the same collectives as data-parallel training (NCCL
over NVLink between the GPUs of a host; jax.distributed across hosts). XLA overlaps the
psum with the backward shading automatically.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

from pbrjax.models.integrator import trace_rays
from pbrjax.ops import rng as rng_mod
from pbrjax.ops.vec import Vec3
from pbrjax.scene.types import CameraState, Scene
from pbrjax.utils.config import RenderSettings


def make_mesh(n_dp: Optional[int] = None, n_sp: int = 1, devices=None):
    """Build a ('dp', 'sp') mesh over the available devices."""
    import jax
    from jax.sharding import Mesh

    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_dp is None:
        n_dp = devices.size // n_sp
    assert n_dp * n_sp <= devices.size, (n_dp, n_sp, devices.size)
    grid = devices[: n_dp * n_sp].reshape(n_dp, n_sp)
    return Mesh(grid, ("dp", "sp"))


def _shard_seed(frame_seed, sp_idx):
    """Distinct, deterministic seed per sample-shard (fold the shard index
    into the frame seed with the same hash used everywhere)."""
    return rng_mod.fold(rng_mod.lowbias32(frame_seed), sp_idx.astype(np.uint32))


def _trace_shard(jnp, scene, cam, settings, ids, frame_seed, axis="sp"):
    import jax

    sp_idx = jax.lax.axis_index(axis)
    seed = _shard_seed(frame_seed, sp_idx)
    res = trace_rays(jnp, scene, cam, settings, ids, seed)
    n_sp = jax.lax.axis_size(axis)
    color = Vec3(
        jax.lax.psum(res.color.x, axis) / n_sp,
        jax.lax.psum(res.color.y, axis) / n_sp,
        jax.lax.psum(res.color.z, axis) / n_sp,
    )
    # Focus channel: average across sample shards (AA jitter differs per
    # shard; an inf from any shard dominates, which DoF maps to "far").
    focus = jax.lax.psum(res.focus_t, axis) / n_sp
    return color, focus


def sharded_render(
    mesh,
    scene: Scene,
    cam: CameraState,
    settings: RenderSettings,
    frame_seed,
    pixel_ids=None,
):
    """Render one frame over the mesh. Returns ``(color: Vec3, focus_t)``
    flat arrays laid out over the 'dp' axis.

    Pixel count must divide by the dp size (pad the image or choose tile
    sizes accordingly — shapes are static).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    npx = settings.width * settings.height
    if pixel_ids is None:
        # Multi-host safe: each process materializes only its own shards
        # (parallel.multihost; on one process this is just a sharded arange).
        from pbrjax.parallel.multihost import host_local_pixel_ids

        pixel_ids = host_local_pixel_ids(mesh, settings.width, settings.height)
    else:
        pixel_ids = jax.device_put(pixel_ids, NamedSharding(mesh, P("dp")))
    scene = jax.device_put(scene, NamedSharding(mesh, P()))
    cam = jax.device_put(cam, NamedSharding(mesh, P()))
    return _render_fn(mesh)(scene, cam, pixel_ids, jnp.uint32(frame_seed), settings)


@functools.lru_cache(maxsize=None)
def _render_fn(mesh):
    """The jitted sharded render for ``mesh`` (one per mesh, so repeated
    frames reuse the compiled program)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    @functools.partial(jax.jit, static_argnames=("settings",))
    def run(scene, cam, ids, seed, settings):
        f = jax.shard_map(
            lambda sc, cm, i, s: _trace_shard(jnp, sc, cm, settings, i, s),
            mesh=mesh,
            in_specs=(P(), P(), P("dp"), P()),
            out_specs=(P("dp"), P("dp")),
        )
        return f(scene, cam, ids, seed)

    return run


def render_params(scene: Scene, cam: CameraState) -> Tuple:
    """The differentiable parameter pytree: materials, light colors and
    positions, camera — the gradient targets named in BASELINE.json."""
    return (scene.materials, scene.lights, cam)


def sharded_train_step(
    mesh,
    scene: Scene,
    cam: CameraState,
    settings: RenderSettings,
    target_rgb,  # (npix, 3) float32, flat pixel order (rows of pixel_ids)
    frame_seed,
    lr: float = 0.0,
    check_vma: bool = True,
    pixel_ids=None,
):
    """One differentiable render + MSE-loss + grad step over the mesh.

    Per-shard ``value_and_grad`` with the cross-shard coupling handled by
    psum transposes; parameter grads are psum-reduced over ('dp','sp') —
    the gradient all-reduce leg of SURVEY.md §2.5. Returns
    ``(loss, grads, new_params)`` with grads/params structured as
    ``render_params``. ``lr > 0`` applies plain SGD to the float leaves.
    ``pixel_ids`` (default: every pixel) restricts the step to those
    pixels; the loss keeps the full frame's normalization, so steps over a
    partition of the frame sum to the full-frame step.
    ``check_vma=False`` is required when the shard body runs Pallas
    kernels in INTERPRET mode (CPU-mesh testing): the interpreter
    evaluates block index_maps as jax ops, mixing unvarying grid indices
    into sharded-array slices (real-chip lowering is unaffected).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    if pixel_ids is None:
        pixel_ids = jnp.arange(settings.width * settings.height, dtype=jnp.int32)
    ids = jax.device_put(pixel_ids, NamedSharding(mesh, P("dp")))
    tr = jax.device_put(jnp.asarray(target_rgb[:, 0]), NamedSharding(mesh, P("dp")))
    tg = jax.device_put(jnp.asarray(target_rgb[:, 1]), NamedSharding(mesh, P("dp")))
    tb = jax.device_put(jnp.asarray(target_rgb[:, 2]), NamedSharding(mesh, P("dp")))
    scene = jax.device_put(scene, NamedSharding(mesh, P()))
    cam = jax.device_put(cam, NamedSharding(mesh, P()))

    run = _train_fn(mesh, check_vma)
    return run(scene, cam, ids, tr, tg, tb, jnp.uint32(frame_seed), settings, lr)


@functools.lru_cache(maxsize=None)
def _train_fn(mesh, check_vma: bool):
    """The jitted sharded train step for ``mesh`` (one per mesh and vma
    mode, so repeated steps reuse the compiled program)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    @functools.partial(jax.jit, static_argnames=("settings", "lr"))
    def run(scene, cam, ids, tr, tg, tb, seed, settings, lr):
        def shard_fn(scene, cam, ids, tr, tg, tb, seed):
            def loss_fn(params):
                """LOCAL loss: this shard's error contribution only. The
                cross-shard sum happens once, after grad — taking grads of a
                psum'd loss would double-count (psum transposes to psum,
                scaling grads by the axis size)."""
                mats, lights, camst = params
                sc = scene._replace(materials=mats, lights=lights)
                color, _ = _trace_shard(jnp, sc, camst, settings, ids, seed)
                err = (
                    (color.x - tr) ** 2 + (color.y - tg) ** 2 + (color.z - tb) ** 2
                )
                return jnp.sum(err) / (3.0 * settings.width * settings.height)

            params = (scene.materials, scene.lights, cam)
            loss_local, grads = jax.value_and_grad(loss_fn, allow_int=True)(params)
            # The sp-psum'd color is identical on every sp shard, so the
            # local loss is sp-replicated; sum over dp tiles for the total.
            loss = jax.lax.psum(loss_local, "dp")
            # Gradient all-reduce: the params are *replicated* (unvarying)
            # inputs, so jax's shard_map autodiff already inserts the psum
            # over ('dp','sp') to keep their cotangents replicated — `grads`
            # leaves this function fully reduced. (An explicit psum here
            # would multiply by the axis sizes; verified against
            # single-device grads in tests/test_sharding.py.) That
            # insertion is part of the vma machinery: with check_vma=False
            # it does NOT happen (measured: dp=8 returned a shard-local
            # grad), so the psum must be explicit in that mode.
            if not check_vma:
                grads = jax.tree_util.tree_map(
                    lambda g: jax.lax.psum(g, ("dp", "sp"))
                    if hasattr(g, "dtype")
                    and jnp.issubdtype(g.dtype, jnp.floating)
                    else g,
                    grads,
                )
            return loss, grads

        loss, grads = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(), P(), P("dp"), P("dp"), P("dp"), P("dp"), P()),
            out_specs=(P(), P()),
            check_vma=check_vma,
        )(scene, cam, ids, tr, tg, tb, seed)

        params = (scene.materials, scene.lights, cam)
        if lr > 0.0:
            params = jax.tree_util.tree_map(
                lambda p, g: p - lr * g
                if hasattr(p, "dtype") and jnp.issubdtype(p.dtype, jnp.floating)
                else p,
                params,
                grads,
            )
        return loss, grads, params

    return run
