from pbrjax.reference.cpu import render_cpu  # noqa: F401
