from pbrjax.models.integrator import trace_rays  # noqa: F401
from pbrjax.models.pathtracer import PathTracer  # noqa: F401
