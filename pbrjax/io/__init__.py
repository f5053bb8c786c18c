from pbrjax.io.lights import LightDef, parse_lights_file  # noqa: F401
from pbrjax.io.mtl import MaterialDef, parse_mtl_file  # noqa: F401
from pbrjax.io.obj import ObjData, parse_obj_file  # noqa: F401

# pbrjax.io.loader (load_model) is imported lazily to avoid a cycle with
# pbrjax.scene.build.


def load_model(*args, **kw):
    from pbrjax.io.loader import load_model as _lm

    return _lm(*args, **kw)
