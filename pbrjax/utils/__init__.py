from pbrjax.utils.config import Config, load_config  # noqa: F401
from pbrjax.utils.log import Logger  # noqa: F401
