"""pbrjax — a differentiable, progressive Monte-Carlo path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
renderer sebadorn/Physically-based-Rendering (C++/OpenCL/Qt): progressive
path tracing of OBJ/MTL scenes through a SAH BVH with physically-based BRDFs
(Schlick, Shirley-Ashikhmin), next-event estimation, refraction, thin-lens
depth of field — restructured as a *wavefront* pipeline over ray batches so
XLA can fuse it into a few device kernels (one NVIDIA GPU by default; the
CPU for tests), sharded over device meshes with `jax.sharding`, and
differentiable w.r.t. materials, lights, and camera.

Package layout
--------------
- ``ops/``       device kernels: intersection, BVH traversal, BRDFs, RNG
- ``models/``    renderer families (wavefront integrator, debug renderers)
- ``parallel/``  device-mesh sharding, multi-chip/multi-host execution
- ``accel/``     host-side SAH BVH builder (NumPy + native C++)
- ``io/``        OBJ / MTL / .lights parsers (reference semantics)
- ``scene/``     scene SoA pytrees, procedural test scenes, camera
- ``reference/`` pure-NumPy oracle tracer used for golden tests
- ``utils/``     config system, logging, timing
"""

__version__ = "0.1.0"

from pbrjax.utils.config import Config, load_config  # noqa: F401
