"""Multi-host execution glue.

The reference was one process on one GPU (SURVEY.md §2.5); scaling past a
chip here means `jax.distributed` + a mesh spanning every host's devices.
NVLink carries the collectives within a host and the network across hosts —
the same `psum`s as single-host, inserted by XLA; nothing in the render or train
step changes. What this module adds is the process-level choreography:

- ``initialize()``: `jax.distributed.initialize` (coordinator, process count
  and id passed explicitly);
- ``global_mesh()``: a ('dp','sp') mesh over *all* devices across hosts;
- ``host_local_pixel_ids()``: each host feeds only its dp-shard of the
  pixel batch (``jax.make_array_from_process_local_data`` assembles the
  global array);
- determinism: the counter RNG keys off *global* pixel ids, so host count
  and layout cannot change the image (tested on the virtual CPU mesh in
  tests/test_sharding.py::test_sharded_render_deterministic_across_layouts).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up the jax distributed runtime. Pass all three arguments
    unless the cluster environment provides them."""
    import jax

    kw = {}
    if coordinator_address is not None:
        kw = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kw)


def global_mesh(n_sp: int = 1):
    """('dp','sp') mesh over every device of every process."""
    from pbrjax.parallel.mesh import make_mesh

    import jax

    return make_mesh(n_dp=len(jax.devices()) // n_sp, n_sp=n_sp)


def pixel_id_sharding(mesh):
    """The ('dp',)-sharded NamedSharding pixel batches use."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    return NamedSharding(mesh, P("dp"))


def shard_index_map(mesh, npx: int):
    """{device: index-tuple} for the (npx,) dp-sharded pixel array, derived
    from the sharding itself — valid for ANY device order / process layout
    (no contiguous-default-order assumption)."""
    return pixel_id_sharding(mesh).devices_indices_map((npx,))


def host_local_pixel_ids(mesh, width: int, height: int, dtype=np.int32):
    """The global (npix,) pixel-id array, each host materializing only the
    shards its own devices address.

    Built with ``jax.make_array_from_callback``: jax asks for exactly the
    index tuples of this process's addressable shards (from
    ``shard_index_map``), so non-contiguous or permuted dp layouts are
    handled by construction. Pixel ids are *global* (the value at global
    index i is i) — the counter RNG keys off them, which is what makes the
    image independent of host count and mesh layout.
    """
    import jax
    import jax.numpy as jnp

    npx = width * height

    def cb(index):
        # index is a tuple of slices into the (npx,) global shape.
        (sl,) = index
        start, stop, step = sl.indices(npx)
        return jnp.arange(start, stop, step, dtype=dtype)

    return jax.make_array_from_callback((npx,), pixel_id_sharding(mesh), cb)


def shard_global_array(mesh, arr):
    """Assemble a dp-sharded global array from a host-side value every
    process holds: each process contributes exactly its own devices'
    shards (``jax.make_array_from_callback`` — the layout-robust sibling
    of ``make_array_from_process_local_data``, which assumes the process's
    shards are one contiguous block)."""
    import jax
    import numpy as np

    arr = np.asarray(arr)

    def cb(index):
        return arr[index]

    return jax.make_array_from_callback(
        arr.shape, pixel_id_sharding(mesh), cb
    )


def multihost_train_step(mesh, scene, cam, settings, target_rgb, frame_seed):
    """One differentiable render + MSE loss + grad all-reduce over a mesh
    that may SPAN PROCESSES — the true multi-process leg of SURVEY §2.5
    (VERDICT r4 item 7: everything multi-device before round 5 was
    single-process).

    Identical math to ``parallel.mesh.sharded_train_step`` (same local
    loss, same psum choreography — see the double-count note there), but
    every global input is built multi-controller-safe: pixel ids via
    ``host_local_pixel_ids``, targets via ``shard_global_array``, and the
    replicated scene/cam/params enter the jit as identical host values on
    every process (the standard multi-controller contract). Collectives
    ride NVLink within a host and the network across hosts; nothing else
    changes.

    Returns ``(loss, grads)`` — both fully replicated, so every process
    sees identical values (the parity assertion of the 2-process leg,
    tools/multiprocess_leg.py).
    """
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from pbrjax.parallel.mesh import _trace_shard

    npx = settings.width * settings.height
    ids = host_local_pixel_ids(mesh, settings.width, settings.height)
    target_rgb = np.asarray(target_rgb, dtype=np.float32)
    tr = shard_global_array(mesh, target_rgb[:, 0])
    tg = shard_global_array(mesh, target_rgb[:, 1])
    tb = shard_global_array(mesh, target_rgb[:, 2])

    @functools.partial(jax.jit, static_argnames=("settings",))
    def run(scene, cam, ids, tr, tg, tb, seed, settings):
        def shard_fn(scene, cam, ids, tr, tg, tb, seed):
            def loss_fn(params):
                mats, lights, camst = params
                sc = scene._replace(materials=mats, lights=lights)
                color, _ = _trace_shard(jnp, sc, camst, settings, ids, seed)
                err = (
                    (color.x - tr) ** 2 + (color.y - tg) ** 2 + (color.z - tb) ** 2
                )
                return jnp.sum(err) / (3.0 * npx)

            params = (scene.materials, scene.lights, cam)
            loss_local, grads = jax.value_and_grad(loss_fn, allow_int=True)(params)
            loss = jax.lax.psum(loss_local, "dp")
            # grads are already ('dp','sp')-psum'd by shard_map autodiff
            # (replicated params -> replicated cotangents; mesh.py note).
            return loss, grads

        return jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(), P(), P("dp"), P("dp"), P("dp"), P("dp"), P()),
            out_specs=(P(), P()),
        )(scene, cam, ids, tr, tg, tb, seed)

    return run(scene, cam, ids, tr, tg, tb, jnp.uint32(frame_seed), settings)
