from pbrjax.accel.bvh import BuildStats, build_bvh  # noqa: F401
