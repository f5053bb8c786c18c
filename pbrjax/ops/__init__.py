from pbrjax.ops import rng  # noqa: F401
