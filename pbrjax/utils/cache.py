"""Persistent XLA compilation cache.

The wavefront integrator is one large fused program; its first compile for a
new (scene-shape, settings) pair costs tens of seconds (the analog of the
reference's per-scene clBuildProgram, CL.cpp:58-80 — which the OpenCL driver
also cached on disk). JAX's persistent compilation cache keys on the HLO, so
re-running the same config — across processes — loads the binary instead of
recompiling.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself; nothing here overrides it), else ``DEFAULT_DIR``, a fixed
directory inside the checkout that ``.gitignore`` lists (a fixed path, since
the path is part of what makes a cache entry hit). Enabled by the CLI, bench
and smoke entry points; set ``PBRJAX_NO_CACHE=1`` to disable (e.g. when
measuring cold compiles).
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache() -> bool:
    """Turn on JAX's on-disk compilation cache. Returns False when disabled
    by ``PBRJAX_NO_CACHE=1``."""
    if os.environ.get("PBRJAX_NO_CACHE") == "1":
        return False
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    # Cache everything that took meaningfully long to compile.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return True
