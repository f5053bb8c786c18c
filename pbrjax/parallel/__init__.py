from pbrjax.parallel.mesh import (  # noqa: F401
    make_mesh,
    sharded_render,
    sharded_train_step,
)
from pbrjax.parallel.multihost import (  # noqa: F401
    global_mesh,
    host_local_pixel_ids,
    multihost_train_step,
)
