from pbrjax.scene.types import (  # noqa: F401
    CameraState,
    LightsSoA,
    LinearBVH,
    MaterialsSoA,
    Scene,
    TrianglesSoA,
)
