"""The TRUE multi-process leg (VERDICT r4 item 7).

Every multi-device artifact before round 5 ran in ONE process (a virtual
8-device CPU mesh). This tool exercises the actual multi-controller path:

- 2 OS processes, each owning 4 virtual CPU devices
  (``--xla_force_host_platform_device_count=4``), joined via
  ``jax.distributed.initialize`` (coordinator on localhost — the DCN-leg
  choreography of SURVEY §2.5, minus the physical network);
- a global ('dp'=8, 'sp'=1) mesh spanning both processes;
- one ``multihost.multihost_train_step``: pixel ids assembled with
  ``host_local_pixel_ids`` (each process materializes only its own
  shards), targets with ``shard_global_array``, grad psum over the mesh;
- PARITY: the replicated (loss, grads) printed by both processes must
  match each other AND a single-process ``mesh.sharded_train_step``
  reference computed by the parent.

Writes docs/MULTIPROC_r05.json. Run: python tools/multiprocess_leg.py
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

SIZE = 32
SEED = 5


def _scene_and_cam():
    from pbrjax.scene.build import scene_from_text
    from pbrjax.scene.camera import make_camera_state
    from pbrjax.scene.procedural import cornell_box

    obj, mtl, li = cornell_box()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=False)
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    return scene, cam


def _settings():
    from pbrjax.utils.config import RenderSettings

    return RenderSettings(
        width=SIZE, height=SIZE, samples=1, max_depth=2, max_added_depth=1,
        shadow_rays=1, anti_aliasing=0.7, sky_light=(0.85, 0.9, 1.0),
        bounce_loop="scan",
    )


def _target():
    import numpy as np

    # Deterministic non-trivial target so the grads are non-zero.
    rs = np.random.RandomState(3)
    return rs.uniform(0.0, 1.0, size=(SIZE * SIZE, 3)).astype(np.float32)


def _grad_digest(grads):
    import numpy as np

    mats, lights, cam = grads
    return {
        "kd.x.sum": float(np.asarray(mats.kd.x).sum()),
        "kd.y.sum": float(np.asarray(mats.kd.y).sum()),
        "light.rgb.x.sum": float(np.asarray(lights.rgb.x).sum()),
        "cam.eye.x": float(np.asarray(cam.eye.x)),
        "cam.eye.y": float(np.asarray(cam.eye.y)),
    }


def child(process_id: int, coordinator: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=2, process_id=process_id
    )
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())
    assert len(jax.local_devices()) == 4

    from pbrjax.parallel.multihost import global_mesh, multihost_train_step

    mesh = global_mesh()
    scene, cam = _scene_and_cam()
    loss, grads = multihost_train_step(
        mesh, scene, cam, _settings(), _target(), SEED
    )
    out = {"process": process_id, "loss": float(loss), "grads": _grad_digest(grads)}
    print("CHILD_RESULT " + json.dumps(out), flush=True)


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(int(sys.argv[2]), sys.argv[3])
        return

    # Pick a free port for the coordinator.
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    coordinator = f"localhost:{port}"

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.setdefault("PYTHONPATH", "")
    env["PYTHONPATH"] = _REPO + os.pathsep + env["PYTHONPATH"]

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", str(i), coordinator],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    results = {}
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        logs.append(out)
        for line in out.splitlines():
            if line.startswith("CHILD_RESULT "):
                r = json.loads(line[len("CHILD_RESULT "):])
                results[r["process"]] = r
        if p.returncode != 0:
            print(out)
            raise SystemExit(f"child failed rc={p.returncode}")
    assert set(results) == {0, 1}, f"missing child results: {results.keys()}"

    # Single-process reference (virtual 8-device mesh in THIS process,
    # pinned to the CPU like the children — it never opens a GPU).
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pbrjax.parallel.mesh import make_mesh, sharded_train_step

    scene, cam = _scene_and_cam()
    loss_ref, grads_ref, _ = sharded_train_step(
        make_mesh(n_dp=8, n_sp=1), scene, cam, _settings(), _target(), SEED
    )
    ref = {"loss": float(loss_ref), "grads": _grad_digest(grads_ref)}

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    checks = {"loss_rel_p0": rel(results[0]["loss"], ref["loss"]),
              "loss_rel_p0_vs_p1": rel(results[0]["loss"], results[1]["loss"])}
    for k in ref["grads"]:
        checks[f"grad_rel[{k}]"] = rel(results[0]["grads"][k], ref["grads"][k])
        checks[f"grad_p0_vs_p1[{k}]"] = rel(
            results[0]["grads"][k], results[1]["grads"][k]
        )
    ok = all(v < 1e-4 for v in checks.values())
    report = {
        "config": f"2 processes x 4 virtual CPU devices, dp=8, {SIZE}x{SIZE}",
        "children": results,
        "single_process_ref": ref,
        "rel_diffs": {k: round(v, 9) for k, v in checks.items()},
        "pass": ok,
    }
    os.makedirs("docs", exist_ok=True)
    with open("docs/MULTIPROC_r05.json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    if not ok:
        raise SystemExit("PARITY FAILED")
    print("[multiprocess_leg] PASS")


if __name__ == "__main__":
    main()
